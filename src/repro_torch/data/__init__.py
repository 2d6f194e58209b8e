from repro_torch.data.timeseries import TimeseriesConfig, TimeseriesIterator, make_batch

__all__ = ["TimeseriesConfig", "TimeseriesIterator", "make_batch"]
