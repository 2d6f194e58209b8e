from repro_torch.data.lm import LMDataConfig, LMIterator, host_slice, make_lm_batch
from repro_torch.data.timeseries import TimeseriesConfig, TimeseriesIterator, make_batch

__all__ = ["LMDataConfig", "LMIterator", "TimeseriesConfig", "TimeseriesIterator",
           "host_slice", "make_batch", "make_lm_batch"]
