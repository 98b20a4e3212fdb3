"""The program's dispatcher, ``step(scene, state, config, DirtyFlags)``,
with the ``dirty`` flags set and the importance grid an earlier step of
the interaction handed on (``ctx["grid"]``), if any. The harness works out
which path the dispatcher takes by its documented rule, counts it and
records it for that path's check (``full_trace``, ``correlated_step`` or
``progressive``):

- light or camera dirty, or TF or volume dirty with no grid: a full
  retrace;
- TF or volume dirty with a grid: a correlated batch of a fresh drain
  round;
- progressive only: a batch of the drain round under way while lanes
  remain and a grid is given, else a progressive pass."""


def path(dirty, grid, n_remaining: int) -> str | None:
    """The dispatcher's path for the ``dirty`` flags."""
    d = set(dirty)
    if d & {"light", "camera"} or (grid is None and d & {"tf", "volume"}):
        return "full_trace"
    if d & {"tf", "volume"}:
        return "correlated_step"
    if "progressive" in d:
        if grid is not None and n_remaining > 0:
            return "correlated_step"
        return "progressive"
    return None


def program(side, scene, state, dirty, grid):
    flags = side.flags(**{k: True for k in dirty})
    return side.step.step(scene, state, side.config, flags,
                          importance_grid=grid)


def reference(side, scene, state, dirty, grid):
    way = path(dirty, grid, 0)
    if way is None:
        return state
    return side.registry.op(way).reference(side, scene, state, *(
        (grid,) if way == "correlated_step" else ()))


def setup(s, step):
    for op in ("full_trace", "correlated_step", "progressive"):
        s.registry.op(op)


def run(s, step, ctx, record):
    dirty, grid = step.params["dirty"], ctx.get("grid")
    before = s.state
    way = path(dirty, grid, int(getattr(before, "n_remaining", 0) or 0))
    s.state = s.on(program, reference)(s.scene, s.state, dirty, grid)
    if way is None:
        return
    op = s.registry.op(way)
    if way == "full_trace":
        op.traced(s, record)
    elif way == "progressive":
        op.passed(s, record, before, True)
    else:
        fresh = bool(set(dirty) & {"tf", "volume"})
        step.mem["correlated"] = True
        op.batched(s, record, ctx, before,
                   None if fresh else before.retraced)


def final(c, step, state):
    if step.mem.get("correlated"):
        c.s.registry.op("correlated_step").final(c, step, state)
