"""plan_stream_s: host seconds of `prepare`'s phase "plan.stream" in
set-up, the stream routing: the block and window counts, the stream
tier's cost model and plan; the program's own clock
(portbench/spans.py::kept)."""

from portbench import spans


def read(rec):
    return spans.kept(rec, "plan.stream")
