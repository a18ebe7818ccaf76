"""Simulation: types, evaluator tables, the exact and flat engines, the
fused kernel.

Two engines share one semantics module (``engine``: SimConfig, finalize,
the audit) and one policy interface (PodView/NodeView):

- ``exact`` (``sim.engine``): the CPython-heapq replica, reference parity
  bit for bit, the layout-dependent retry rule included;
- ``flat`` (``sim.flat``): the slot-per-pod queue, whose retry rule
  differs by design (see its module docstring).

``get_engine(name)`` is the one dispatch point for an engine choice.
"""


def get_engine(name: str):
    """Engine module for ``name`` ("exact" | "flat"). Both expose
    initial_state, build_step, lane_active, finalize, make_run_fn,
    make_param_run_fn, make_population_run_fn and simulate."""
    if name == "exact":
        from fks_tpu_torch.sim import engine
        return engine
    if name == "flat":
        from fks_tpu_torch.sim import flat
        return flat
    if name == "fused":
        raise ValueError(
            "the fused kernel is not a general engine module — it "
            "hard-wires the parametric policy and has no single-policy "
            "surface. Use parallel.make_population_eval(engine='fused') "
            "(or fks_tpu_torch.sim.fused directly) for parametric "
            "populations; 'exact'/'flat' elsewhere.")
    raise ValueError(f"unknown engine {name!r}; expected 'exact' or 'flat'")
