"""The benchmark of ``timewarp_tpu_torch`` on one H100: see ``run.py``."""
