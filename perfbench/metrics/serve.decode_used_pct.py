"""``serve.decode_used_pct``: the engine's decode steps whose token was
served to at least one request over all its decode steps, in the profiled
wave (``engine.decode_steps_used`` / ``engine.decode_steps``), in
percent."""
from perfbench import program_obs


def read(rec, peak):
    if rec.get("kind") != "serve":
        return None
    return program_obs.ratio_pct(program_obs.counter("engine.decode_steps_used", None),
                                 program_obs.counter("engine.decode_steps", None))
