import torch


def score(graphs, x):
    def body(x):
        if x.sum() > 0:
            return torch.abs(x)
        while x.max() > 1:
            x = x / 2
        assert torch.isfinite(x).all()
        return x

    return graphs.run(("score",), body, (x,))
