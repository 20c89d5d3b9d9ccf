"""Utilities of the port (counterpart of frlw_evd_tpu/utils)."""
