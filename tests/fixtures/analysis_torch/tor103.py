import numpy as np
import torch


def run(engine, x):
    def body(x):
        y = x * 2
        n = y.sum().item()
        rows = y.tolist()
        host = y.cpu()
        arr = np.asarray(y)
        torch.cuda.synchronize()
        return n, rows, host, arr

    return engine.run_program("body", body, (x,))
