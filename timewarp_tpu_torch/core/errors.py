"""Exception hierarchy for the framework
(the port's copy of ``timewarp_tpu/core/errors.py``).

Mirrors the error surface of the reference:

- ``TimedError`` / ``TimeoutExpired``  ≙  ``MonadTimedError(MTTimeoutError)``
  (`/root/reference/src/Control/TimeWarp/Timed/MonadTimed.hs:69-73`)
- ``ThreadKilled``  ≙  ``Control.Exception.AsyncException(ThreadKilled)``
  as used by ``killThread`` (MonadTimed.hs:204-206)
- ``TransferError`` family  ≙  ``TransferException``/``PeerClosedConnection``
  (`/root/reference/src/Control/TimeWarp/Rpc/Transfer.hs:154-170`)
"""

from __future__ import annotations


class TimeWarpError(Exception):
    """Root of all framework-raised errors."""


# Timed layer ------------------------------------------------------------

class TimedError(TimeWarpError):
    """≙ ``MonadTimedError`` (MonadTimed.hs:69-73)."""


class TimeoutExpired(TimedError):
    """Raised by ``timeout`` when the action overruns
    (≙ ``MTTimeoutError``, MonadTimed.hs:69-73; thrown at TimedT.hs:370-376)."""


class DeadlockError(TimedError):
    """Delivered by the pure emulator to every thread still ``Park``\\ ed
    when the event queue drains: nothing can ever wake it again.

    ≙ GHC's ``BlockedIndefinitelyOnMVar`` — the reference inherits that
    detection from the RTS; the emulator must provide it explicitly or a
    deadlocked scenario would be indistinguishable from quiescence.
    Delivered *into* the thread (catchable; ``finally`` blocks run).
    """


class ThreadKilled(Exception):
    """Async exception delivered by ``kill_thread``
    (≙ ``AsyncException ThreadKilled``, MonadTimed.hs:204-206).

    Deliberately *not* a ``TimeWarpError``: user code catching the
    framework error root should not swallow kill signals by accident.
    """


# Network layer ----------------------------------------------------------

class TransferError(TimeWarpError):
    """≙ ``TransferException`` (Transfer.hs:154-161)."""


class AlreadyListening(TransferError):
    """Second listener attached to one connection
    (≙ ``AlreadyListeningOutbound``, Transfer.hs:157-161; single-listener
    rule documented at MonadTransfer.hs:23-33)."""


class PeerClosedConnection(TransferError):
    """Remote end closed the socket (≙ Transfer.hs:163-170)."""


class ConnectError(TransferError):
    """Connection could not be established — port unbound, peer
    unreachable, or the link model dropped the connect attempt (≙ the
    OS-level connect failure that feeds ``withRecovery``'s
    ``reconnectPolicy`` loop, Transfer.hs:585-603, and the old API's
    ``NeverConnected`` outcome)."""


class SocketBroken(TransferError):
    """The connection broke mid-stream — abrupt reset, not a clean EOF
    (≙ the socket IOErrors that ``sfProcessSocket``'s workers surface to
    ``withRecovery``, Transfer.hs:383-401)."""


class MailboxOverflow(TimeWarpError):
    """A simulated node's bounded mailbox overflowed in the batched engine.

    The reference's unbounded event queue can't overflow; the XLA engine's
    fixed-capacity mailboxes can, and overflow must be *detected and
    reported*, never silent (SURVEY.md §7 build-plan requirement).
    """


class NetworkError(TimeWarpError):
    """RPC/dialog-level failure (≙ the removed RpcError surface referenced
    by MonadRpc.hs.unused)."""
