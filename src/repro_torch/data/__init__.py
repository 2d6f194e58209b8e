from repro_torch.data.timeseries import TimeseriesConfig, make_batch

__all__ = ["TimeseriesConfig", "make_batch"]
