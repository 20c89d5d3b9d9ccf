"""Event encoders (counterpart of frlw_evd_tpu/encode): raw (x, y, t, p)
events → dense volumes.

Four representations: Event Count Image, Surface of Active Events, Event
Volume and Temporal Active Focus (TAF), offline (`count_image`, `sae`,
`event_volume`, `taf`) and streaming with state carry (`streaming`), with
the numpy reference `oracle`. The TAF serving steps run the CUDA kernels
B1, B2, B3, B5 and B6 (`scatter`, `update`) on CUDA tensors and their plain
twins on CPU tensors; `mxu_scatter` holds JAX's histogram functions.
"""

from . import oracle, streaming
from .common import events_struct_to_xytp, nearest_resize_chw, pad_events
from .count_image import encode_count_image, encode_count_image_batch
from .event_volume import encode_event_volume, encode_event_volume_batch
from .mxu_scatter import (scatter_add_mxu, scatter_cnt_tsum_mxu,
                          segment_last_sorted)
from .sae import encode_sae, encode_sae_batch, sae_init_state
from .scatter import (event_cells, scatter_cnt_tsum, scatter_cnt_tsum_pallas,
                      scatter_cnt_tsum_pallas_plain,
                      scatter_cnt_tsum_pallas_sorted,
                      scatter_cnt_tsum_pallas_sorted_plain,
                      scatter_cnt_tsum_plain, scatter_cnt_tsum_sorted)
from .streaming import (EVState, ev_init_state, event_frame_stream,
                        event_volume_stream, sae_stream, taf_pack_state,
                        taf_stream_step, taf_stream_step_folded,
                        taf_stream_step_packed, taf_unpack_state)
from .taf import (bucket_events_for_taf, encode_taf_window, leaky_transform,
                  taf_bin_step, taf_init_state, taf_state_to_volume)
from .update import (init_state, p64_init_state, taf_stream_step_kernel,
                     taf_stream_step_kernel_p64, taf_update_leaky,
                     taf_update_leaky_plain, taf_update_leaky_raw,
                     taf_update_leaky_raw_plain, taf_update_leaky_v2,
                     taf_update_leaky_v2_plain)

__all__ = ["EVState", "bucket_events_for_taf", "encode_count_image",
           "encode_count_image_batch", "encode_event_volume",
           "encode_event_volume_batch", "encode_sae", "encode_sae_batch",
           "encode_taf_window", "ev_init_state", "event_cells",
           "event_frame_stream", "event_volume_stream",
           "events_struct_to_xytp", "init_state", "leaky_transform",
           "nearest_resize_chw", "oracle", "p64_init_state", "pad_events",
           "sae_init_state", "sae_stream", "scatter_add_mxu",
           "scatter_cnt_tsum", "scatter_cnt_tsum_mxu",
           "scatter_cnt_tsum_pallas", "scatter_cnt_tsum_pallas_plain",
           "scatter_cnt_tsum_pallas_sorted",
           "scatter_cnt_tsum_pallas_sorted_plain", "scatter_cnt_tsum_plain",
           "scatter_cnt_tsum_sorted", "segment_last_sorted", "streaming",
           "taf_bin_step", "taf_init_state", "taf_pack_state",
           "taf_state_to_volume", "taf_stream_step",
           "taf_stream_step_folded", "taf_stream_step_kernel",
           "taf_stream_step_kernel_p64", "taf_stream_step_packed",
           "taf_unpack_state", "taf_update_leaky", "taf_update_leaky_plain",
           "taf_update_leaky_raw", "taf_update_leaky_raw_plain",
           "taf_update_leaky_v2", "taf_update_leaky_v2_plain"]
