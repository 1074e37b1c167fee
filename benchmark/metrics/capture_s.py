"""``capture_s``: the benchmark's span around the first ``prepare`` of the
solve graph (``solver/graph.py`` ``CycleGraph.prepare``: one eager
iteration on scratch buffers, then the capture), synchronised on both
sides, in s.  None off the card, where nothing is captured."""


def read(run):
    return run.spans.get("capture")
