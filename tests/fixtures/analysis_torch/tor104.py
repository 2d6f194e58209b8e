import numpy as np
import torch

from repro_torch.engine.capture import CapturedProgram


def capture(x, stream):
    def body(x):
        scale = torch.tensor([0.5, 2.0], device=x.device)
        bias = torch.as_tensor(np.ones(2, np.float32), device=x.device)
        table = torch.from_numpy(np.arange(2.0))
        return x * scale + bias + table.to(x.device)

    return CapturedProgram(body, (x,), x.device, stream)
