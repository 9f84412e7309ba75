"""``serve.decode_launches``: the host's kernel launches (events named
``cudaLaunch*`` or ``cuLaunch*``) inside the program's
``model.decode_step`` spans of the profiled wave, a step."""
import bisect

from perfbench import program_obs


def read(rec, peak):
    if rec.get("kind") != "serve":
        return None
    steps = program_obs.host_spans(rec.get("trace"), "model.decode_step")
    starts = program_obs.launches(rec.get("trace"))
    if not steps or not starts:
        return None
    inside = sum(bisect.bisect_right(starts, e) - bisect.bisect_left(starts, s) for s, e in steps)
    return inside / len(steps)
