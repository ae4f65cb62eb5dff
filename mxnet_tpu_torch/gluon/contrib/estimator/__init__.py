"""The Estimator fit loop (port of ``mxnet_tpu/gluon/contrib/estimator``)."""
from .estimator import Estimator
from .event_handler import (TrainBegin, TrainEnd, EpochBegin, EpochEnd,
                            BatchBegin, BatchEnd, StoppingHandler,
                            MetricHandler, ValidationHandler,
                            LoggingHandler, CheckpointHandler,
                            EarlyStoppingHandler, GradientUpdateHandler)

__all__ = ["Estimator", "TrainBegin", "TrainEnd", "EpochBegin", "EpochEnd",
           "BatchBegin", "BatchEnd", "StoppingHandler", "MetricHandler",
           "ValidationHandler", "LoggingHandler", "CheckpointHandler",
           "EarlyStoppingHandler", "GradientUpdateHandler"]
