from temporalalignnet_torch.utils.logging import MetricsWriter
from temporalalignnet_torch.utils.meters import AverageMeter, ProgressMeter
from temporalalignnet_torch.utils.profiling import (StepBreakdown, StepTimer, device_memory_stats,
                                                    trace)

__all__ = ["AverageMeter", "MetricsWriter", "ProgressMeter", "StepBreakdown", "StepTimer",
           "device_memory_stats", "trace"]
