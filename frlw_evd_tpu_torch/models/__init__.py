"""Detector zoo of the port (counterpart of frlw_evd_tpu/models): the AED
and yolox families, with decode, NMS, seq-NMS and the SimOTA training
loss."""

from .detector import EventDetector, build_detector, detector_loss, eval_decode
from .postprocess import (finalize_detections, postprocess_batch,
                          postprocess_image)

__all__ = ["EventDetector", "build_detector", "detector_loss", "eval_decode",
           "finalize_detections", "postprocess_batch", "postprocess_image"]
