"""Device milliseconds of one institutional chunk
(``ops/slab_chunk.slab_chunk_summaries``, swapped where its caller looks
it up, ``parallel/mc_runner``): CUDA events around every call in the
traced window's reports after the profiled first one, the calls' spans
summed and divided by their count."""

TARGET = ("letf_tpu_torch.parallel.mc_runner", "slab_chunk_summaries")


def install(run):
    run.clock(*TARGET)


def read(run):
    calls = run.calls_ms(*TARGET)
    return sum(ms for _, ms in calls) / len(calls) if calls else None
