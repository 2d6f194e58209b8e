_graph_cache = {}


def lookup(fn, shape):
    return _graph_cache.get(f"{fn.__name__}:{shape}")


def store(fn, graph):
    _graph_cache[id(fn)] = graph


def replay(graphs, name, fn, x):
    return graphs.run(f"{name}:{tuple(x.shape)}", fn, (x,))
