"""K2's share of its cycles in Mip-NeRF's integrated positional encoding
(both encodings of every chunk: before the first layer and again at the
skip layer), which lie inside its scalar phase: the engine's
``plcore_two_pass_cycles_encode`` over ``plcore_two_pass_cycles_total``,
as deltas over the window, counted by the traced Mip-NeRF instance in
every tile drained. None without the counters (a program without them)
or where nothing counted them (a model without the encoding)."""

PHASE = "plcore_two_pass_cycles_encode"
TOTAL = "plcore_two_pass_cycles_total"


def read(run):
    if PHASE not in run.stats1 or TOTAL not in run.stats1:
        return None
    total = run.stats1[TOTAL] - run.stats0[TOTAL]
    encode = run.stats1[PHASE] - run.stats0[PHASE]
    if total <= 0 or encode <= 0:
        return None
    return 100.0 * encode / total
