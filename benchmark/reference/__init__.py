"""The plain reference the benchmark holds the program against.

Plain PyTorch over whole node axes, written from the emulation's
semantics: it imports nothing of the program and takes none of its
tables. ``rng`` is the counter-based Threefry stream, ``links`` the link
models a configuration names, ``models/`` one file per scenario family
(found by the family's name) and ``engine`` the superstep.
"""
