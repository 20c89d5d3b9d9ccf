"""Utilities of the port (counterpart of frlw_evd_tpu/utils): metrics,
profiling, logging, host NMS and box converters, and drawing."""

from .metric import AverageMeter, MeterBuffer
from .profiling import Timer, flops_report, trace
from .logger import setup_logger
from .demo_utils import multiclass_nms, nms, xyxy2cxcywh, cxcywh2xyxy
