"""Streaming event encoders (counterpart of frlw_evd_tpu/encode)."""

from .scatter import (event_cells, scatter_cnt_tsum, scatter_cnt_tsum_pallas,
                      scatter_cnt_tsum_pallas_plain,
                      scatter_cnt_tsum_pallas_sorted,
                      scatter_cnt_tsum_pallas_sorted_plain,
                      scatter_cnt_tsum_plain, scatter_cnt_tsum_sorted)
from .taf import leaky_transform
from .update import (init_state, p64_init_state, taf_stream_step_kernel,
                     taf_stream_step_kernel_p64, taf_update_leaky,
                     taf_update_leaky_plain, taf_update_leaky_raw,
                     taf_update_leaky_raw_plain, taf_update_leaky_v2,
                     taf_update_leaky_v2_plain)

__all__ = ["event_cells", "init_state", "leaky_transform", "p64_init_state",
           "scatter_cnt_tsum", "scatter_cnt_tsum_pallas",
           "scatter_cnt_tsum_pallas_plain", "scatter_cnt_tsum_pallas_sorted",
           "scatter_cnt_tsum_pallas_sorted_plain", "scatter_cnt_tsum_plain",
           "scatter_cnt_tsum_sorted", "taf_stream_step_kernel",
           "taf_stream_step_kernel_p64", "taf_update_leaky",
           "taf_update_leaky_plain", "taf_update_leaky_raw",
           "taf_update_leaky_raw_plain", "taf_update_leaky_v2",
           "taf_update_leaky_v2_plain"]
