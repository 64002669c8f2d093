from .config import Config, deep_merge_dicts, read_config
from .log import AverageMeter, EMAMeter, ScalarSink, TextLogger, VariableRecord, build_logger
from .timing import EasyTimer, StopWatch

__all__ = ["AverageMeter", "Config", "EMAMeter", "EasyTimer", "ScalarSink", "StopWatch", "TextLogger",
           "VariableRecord", "build_logger", "deep_merge_dicts", "read_config"]
