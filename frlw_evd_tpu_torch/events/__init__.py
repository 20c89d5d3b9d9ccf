"""Event file I/O: Prophesee .dat / structured .npy codecs and stream readers
(the port's own copy of frlw_evd_tpu/events, numpy only).

Pure numpy, CPU-side. Bit-compatible with the Prophesee Automotive Dataset
Toolbox formats used by the reference (data/prophesee/, src/io/).
"""

from .dat_codec import (
    EV_TYPE,
    pack_events,
    unpack_events,
    parse_dat_header,
    count_events,
    load_td_data,
    write_dat_header,
    write_event_buffer,
)
from .npy_codec import parse_npy_header
from .box_loading import BBOX_DTYPE, reformat_boxes, boxes_to_array
from .psee_loader import PSEELoader
