"""Streaming event encoders (counterpart of frlw_evd_tpu/encode)."""

from .scatter import scatter_cnt_tsum, scatter_cnt_tsum_plain
from .taf import leaky_transform
from .update import (init_state, p64_init_state, taf_stream_step_kernel,
                     taf_stream_step_kernel_p64, taf_update_leaky,
                     taf_update_leaky_plain, taf_update_leaky_raw,
                     taf_update_leaky_raw_plain)

__all__ = ["init_state", "leaky_transform", "p64_init_state",
           "scatter_cnt_tsum", "scatter_cnt_tsum_plain",
           "taf_stream_step_kernel", "taf_stream_step_kernel_p64",
           "taf_update_leaky", "taf_update_leaky_plain",
           "taf_update_leaky_raw", "taf_update_leaky_raw_plain"]
