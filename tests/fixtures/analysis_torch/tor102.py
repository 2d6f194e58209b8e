import functools

LOG = []
_calls = 0


class Pool:
    def step(self, engine, x):
        engine.run_program("step", functools.partial(self._advance, 0), (x,))

    def _advance(self, i, x):
        global _calls
        print("stepping", i)
        LOG.append(i)
        self.steps += 1
        self.total += x.sum()
