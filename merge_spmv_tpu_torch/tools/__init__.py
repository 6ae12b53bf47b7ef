"""Measurement tools of the port (sm_ceiling.py: the op-class probe P1)."""
