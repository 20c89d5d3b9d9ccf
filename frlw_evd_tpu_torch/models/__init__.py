"""Detector zoo of the port (counterpart of frlw_evd_tpu/models): the AED
family at eval, with decode and NMS."""

from .detector import EventDetector, build_detector, eval_decode
from .postprocess import postprocess_batch, postprocess_image

__all__ = ["EventDetector", "build_detector", "eval_decode",
           "postprocess_batch", "postprocess_image"]
