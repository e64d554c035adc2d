"""Multi-device batch path: a (dp, sp) mesh of devices (spmd.py) and its
dry run (dryrun.py)."""
