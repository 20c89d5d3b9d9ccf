"""Prophesee-compatible COCO evaluation pipeline (the port's own copy of
frlw_evd_tpu/evaluate, numpy only).

Port targets (bit-compatibility gates, SURVEY.md §7.6):
  * box_filtering — GEN1/GEN4/KITTI min-size + skip-time rules
  * coco_eval     — timestamp-tolerant GT/DT windowing (_match_times) and
                    COCO-format conversion
  * coco_map      — self-contained numpy implementation of COCOeval bbox AP
                    (pycocotools is not available in this image); follows the
                    published COCO evaluation protocol exactly
  * evaluator     — accumulation, rescaling, latency counters, recorder
"""

from .box_filtering import (
    filter_boxes,
    filter_boxes_gen1,
    filter_boxes_large,
    filter_boxes_kitti,
)
from .coco_eval import evaluate_detection
from .coco_map import COCOMeanAP
from .evaluator import Evaluator, Recorder
