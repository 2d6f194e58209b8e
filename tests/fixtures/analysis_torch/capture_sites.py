import torch


def forward(x):
    return x.relu().item()


def capture(graph, x):
    with torch.cuda.graph(graph):
        y = x * 2
        n = y.sum().item()
    return torch.cuda.make_graphed_callables(forward, (x,)), n
