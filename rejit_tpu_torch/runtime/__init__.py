"""Runtime bootstrap: the process group of multi-process runs (init.py)."""
