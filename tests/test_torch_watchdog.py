"""The port's parity sentinel and offline divergence audit
(fks_tpu_torch.obs.watchdog) against fks_tpu's, on the CPU.

- ``ParitySentinel.check`` with ``sample > 0``: the same picks (one
  ``random.Random(seed)``), stats, ``parity`` metrics and ``alert``
  events as fks_tpu's sentinel over the same stub reference;
- ``audit_served``: the same rows for a passing answer, a drifted score
  and diverging placements;
- the offline audit: ``panel_sources`` and, for one trace cut to its
  first pods, ``audit_trace``'s row and ``format_audit_table``'s table;
- ``EvolutionConfig(parity_sample=2)`` on the exact engine with
  ``FakeLLM(seed=7)``: the run and its sentinel rows equal fks_tpu's.
"""
import pytest

import fks_tpu.obs.watchdog as jax_wd
import fks_tpu_torch.obs.watchdog as wd
from fks_tpu_torch.testing import one_torch_thread
from tests.test_engine_micro import micro_workload
from tests.test_torch_evolution import assert_runs_match, both_runs


class Rec:
    enabled = True

    def __init__(self):
        self.metrics, self.events = [], []

    def metric(self, kind, record=None, **fields):
        self.metrics.append((kind, dict(record or fields)))

    def event(self, kind, **fields):
        self.events.append((kind, fields))


class _Record:
    def __init__(self, v):
        self.ok = v != "not-ok"
        self.score = v if self.ok else 0.0


class StubReference:
    """A reference evaluator returning canned scores by code."""

    def __init__(self, table):
        self.table = table

    def evaluate_one(self, code):
        v = self.table[code]
        if v == "raise":
            raise RuntimeError("reference blew up")
        return _Record(v)


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def both_sentinels(table, **kw):
    out = []
    for mod in (wd, jax_wd):
        rec = Rec()
        s = mod.ParitySentinel(object(), recorder=rec, trace_diff=False,
                               **kw)
        s._ref = StubReference(table)
        out.append((s, rec))
    return out


@pytest.mark.parametrize("table,population,sample", [
    ({"a": 0.5, "b": 0.25}, [("a", 0.5), ("b", 0.25)], 2),
    ({"a": 0.5, "b": 0.26}, [("a", 0.5), ("b", 0.25)], 2),
    ({"a": "raise", "b": "not-ok", "c": 0.75},
     [("a", 0.1), ("b", 0.2), ("c", 0.75)], 3),
    ({k: 0.1 * i for i, k in enumerate("abcdefgh")},
     [(k, 0.1 * i + (0.02 if k in "cf" else 0.0))
      for i, k in enumerate("abcdefgh")], 3),
])
def test_sampling_check_matches_fks_tpu(table, population, sample):
    (s, rec), (js, jrec) = both_sentinels(table, sample=sample, tol=1e-5,
                                          seed=3)
    for gen in range(3):
        assert s.check(gen, population) == js.check(gen, population)
    assert (s.alerts, s.checked, s.max_drift) == \
        (js.alerts, js.checked, js.max_drift)
    assert rec.metrics == jrec.metrics and rec.events == jrec.events


def test_sample_zero_is_a_noop():
    s = wd.ParitySentinel(object(), sample=0)
    assert s.check(1, [("a", 1.0)]) == {"generation": 1, "checked": 0,
                                         "max_drift": 0.0, "alerts": 0}
    assert s._ref is None


def test_audit_served_rows_match():
    (s, rec), (js, jrec) = both_sentinels({}, tol=1e-5)
    for sent in (s, js):
        assert sent.audit_served("r1", 0.5, 0.5)
        assert not sent.audit_served("r2", 0.5, 0.6)  # drift
        assert not sent.audit_served("r3", 0.5, 0.5,
                                     placements_match=False)
    assert (s.alerts, s.checked) == (js.alerts, js.checked) == (2, 3)
    assert rec.metrics == jrec.metrics and rec.events == jrec.events
    assert [f["source"] for k, f in rec.events if k == "alert"] == \
        ["serve_parity", "serve_parity"]


def test_audit_alert_carries_the_first_divergence():
    """With trace_diff on, an alert replays the worst offender through
    ``candidate_trace_diff`` on the evaluator's workload and attaches the
    first divergent step (here the VM tier differs from nothing: no
    divergence, the fields are present and empty)."""
    from fks_tpu_torch.funsearch import CodeEvaluator, seed_policies
    from fks_tpu_torch.testing import port_workload

    ev = CodeEvaluator(port_workload(micro_workload()), device="cpu")
    rec = Rec()
    s = wd.ParitySentinel(ev, sample=1, tol=1e-5, recorder=rec)
    code = seed_policies()["first_fit"]
    s._ref = StubReference({code: 0.9})
    assert s.check(0, [(code, 0.1)])["alerts"] == 1
    (kind, alert), = [e for e in rec.events if e[0] == "alert"]
    assert alert["source"] == "parity" and "first_divergence" in alert
    assert alert["first_divergence"] is None


def test_panel_sources_match():
    assert wd.panel_sources(3) == jax_wd.panel_sources(3)


def test_offline_audit_row_and_table_match(monkeypatch):
    """One trace, cut to its first 40 pods in both packages, through the
    seed panel on both engines: the row and the table equal fks_tpu's."""
    import fks_tpu.data as jax_data

    read = jax_data.TraceParser._read_csv  # fks_tpu has no max_pods
    monkeypatch.setattr(jax_data.TraceParser, "_read_csv", staticmethod(
        lambda path: read(path)[:40] if "pod_list" in str(path)
        else read(path)))
    from fks_tpu_torch.funsearch import template

    sources = {k: v for k, v in template.seed_policies().items()}
    pod_file = "openb_pod_list_multigpu20.csv"
    row = wd.audit_trace(pod_file, sources, {}, device="cpu", max_pods=40)
    jrow = jax_wd.audit_trace(pod_file, sources, {})
    assert row == jrow
    assert wd.format_audit_table([row]) == jax_wd.format_audit_table([jrow])
    bad = {"trace": "missing.csv", "error": "FileNotFoundError: x"}
    assert wd.format_audit_table([row, bad]) == \
        jax_wd.format_audit_table([jrow, bad])
    assert wd.format_audit_table([]) == jax_wd.format_audit_table([])


def test_run_audit_writes_jsonl(tmp_path):
    from fks_tpu_torch.funsearch import template

    out = tmp_path / "audit.jsonl"
    rows = wd.run_audit(str(out), ["openb_pod_list_multigpu20.csv"],
                        top_champions=0, log=lambda m: None, device="cpu",
                        max_pods=12)
    assert len(rows) == 1 and "error" not in rows[0]
    assert set(rows[0]["policies"]) == set(template.seed_policies())
    assert len(out.read_text().splitlines()) == 1


def test_evolution_with_parity_sampling_matches_fks_tpu():
    """EvolutionConfig(parity_sample=2): the sampling sentinel runs every
    generation and its rows (and the whole run) equal fks_tpu's."""
    fs, jfs, rec, jrec = both_runs(micro_workload(), parity_sample=2)
    assert_runs_match(fs, jfs, rec, jrec)
    parity = [r for r in rec.rows if r[1] == "parity"]
    assert parity and parity == [r for r in jrec.rows if r[1] == "parity"]
    assert sum(h.parity_checked for h in fs.history) == \
        2 * len(fs.history)
    assert fs.sentinel.alerts == 0
