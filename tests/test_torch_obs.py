"""The port's copies of the accounting and integrity planes against the
JAX package's classes, on the CPU.

Every case feeds the same call sequence, generated from a numpy seed,
to the JAX class and to the port's copy and compares what they give
back (``state()`` / ``summary()`` / rendered text) for equality:
the metrics manager's Prometheus and OpenMetrics text, fault plans
(parsing, refusals, trips), the event ledger (JSONL and
``parse_events`` round trip, unknown kinds refused, ring drops), the
goodput meter (conservation over mixed passes), the cost model
(baseline seal, drift episodes), the SLO tracker (burn windows), the
usage ledger (rollups), the watermark tracker, the recompile sentinel,
``parse_window``, ``request_digest`` and the integrity plane over a
golden set this test writes and both packages load. Also: the engine's
MFU basis (``llama_decode_flops``) against ``FlopCounterMode`` over the
plain decode step at the tiny config, and ``device_peak_flops`` by card
name.
"""

import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gofr_tpu.metrics import registry as jax_registry
from gofr_tpu.serving import costmodel as jax_costmodel
from gofr_tpu.serving import events as jax_events
from gofr_tpu.serving import faults as jax_faults
from gofr_tpu.serving import integrity as jax_integrity
from gofr_tpu.serving import observability as jax_obs
from gofr_tpu_torch import metrics as port_metrics
from gofr_tpu_torch.models.llama import (LlamaConfig, llama_decode_flops,
                                         llama_decode_step_paged, llama_init,
                                         make_pool)
from gofr_tpu_torch.serving import costmodel as port_costmodel
from gofr_tpu_torch.serving import events as port_events
from gofr_tpu_torch.serving import faults as port_faults
from gofr_tpu_torch.serving import integrity as port_integrity
from gofr_tpu_torch.serving import observability as port_obs

torch.set_num_threads(2)

BOTH = ("jax", "port")


# ------------------------------------------------------------- metrics
def _drive_manager(mod, seed: int):
    """Register a few series of every kind and write a seeded sequence
    of observations, labelled and not, with exemplars on some."""
    rng = np.random.default_rng(seed)
    m = mod.Manager()
    m.new_counter("app_c", "a counter")
    m.new_gauge("app_g", 'a gauge with "quotes" \\ and \n a newline')
    m.new_up_down_counter("app_u", "an up/down counter")
    m.new_histogram("app_h", "a histogram", buckets=(0.01, 0.1, 1, 10))
    m.new_histogram("app_d", "default buckets")
    tenants = ["a", "b", 'q"uote']
    for i in range(200):
        op = int(rng.integers(0, 5))
        labels = {} if rng.random() < 0.3 else {
            "tenant": tenants[int(rng.integers(0, 3))]}
        value = float(rng.choice([0.0, 1.0, 2.5, rng.random() * 20.0]))
        if op == 0:
            m.increment_counter("app_c", **labels)
        elif op == 1:
            m.add_counter("app_c", value, **labels)
        elif op == 2:
            m.set_gauge("app_g", value, **labels)
        elif op == 3:
            m.delta_up_down_counter("app_u", value - 10.0, **labels)
        else:
            name = "app_h" if rng.random() < 0.5 else "app_d"
            trace = f"t{i:04x}" if rng.random() < 0.5 else None
            m.record_histogram(name, value, exemplar_trace_id=trace,
                               **labels)
    # writes to names that are not registered (as that kind) are dropped
    m.increment_counter("app_missing")
    m.set_gauge("app_c", 1.0)
    return m


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("form", ["prometheus", "openmetrics"])
def test_manager_renders_the_same_text(seed, form, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.123456)
    texts = []
    for mod in (jax_registry, port_metrics):
        m = _drive_manager(mod, seed)
        texts.append(m.render_prometheus() if form == "prometheus"
                     else m.render_openmetrics())
        assert m.get_histogram_count("app_h") >= 0
    assert texts[0] == texts[1]
    assert "app_c" in texts[1] and "app_h_bucket" in texts[1]


def test_manager_refuses_a_second_registration():
    for mod in (jax_registry, port_metrics):
        m = mod.Manager()
        m.new_gauge("app_x", "x")
        with pytest.raises(mod.MetricsError):
            m.new_counter("app_x", "x")


# -------------------------------------------------------------- faults
PLANS = ["", "pass_raise:at=3", "pass_stall:at=5,seconds=0;pass_latency",
         "logit_corrupt:request=_integrity,times=0",
         "cost_skew:request=decode/0,at=2,seconds=1.5;page_exhaustion:times=2",
         "nan_logits:at=2,times=3;heartbeat_drop:at=1,times=0"]
BAD_PLANS = ["bogus_site", "pass_raise:at=0", "pass_raise:at=x",
             "pass_stall:seconds=abc", "pass_raise;;nan_logits",
             ":at=1", "pass_raise:when=3"]


def _trip_sequence(mod, text: str, seed: int) -> tuple:
    plan = mod.FaultPlan.parse(text)
    rng = np.random.default_rng(seed)
    sites = sorted(mod.SITES)
    results = []
    for _ in range(60):
        site = sites[int(rng.integers(0, len(sites)))]
        rid = [None, "_integrity", "decode/0", "x"][int(rng.integers(0, 4))]
        try:
            results.append(plan.trip(site, rid))
        except mod.InjectedFault as exc:
            results.append(str(exc))
    return (repr(plan), plan.enabled, plan.describe(), dict(plan.fired),
            results, plan.payload("cost_skew"))


@pytest.mark.parametrize("text", PLANS)
def test_fault_plans_parse_and_trip_alike(text):
    assert _trip_sequence(jax_faults, text, 3) == \
        _trip_sequence(port_faults, text, 3)
    for mod in (jax_faults, port_faults):
        assert (mod.FaultPlan.parse(text) is mod.NO_FAULTS) == (not text)
        assert mod.resolve_plan(text).describe() == \
            mod.FaultPlan.parse(text).describe()


@pytest.mark.parametrize("text", BAD_PLANS)
def test_fault_plans_refuse_the_same_mistakes(text):
    errors = []
    for mod in (jax_faults, port_faults):
        with pytest.raises(ValueError) as info:
            mod.FaultPlan.parse(text)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_fault_plan_from_the_environment(monkeypatch):
    monkeypatch.setenv("GOFR_FAULTS", "pass_stall:at=2,seconds=0.5")
    assert port_faults.plan_from_env().describe() == \
        jax_faults.plan_from_env().describe()
    monkeypatch.delenv("GOFR_FAULTS")
    assert port_faults.resolve_plan(None) is port_faults.NO_FAULTS


# -------------------------------------------------------------- events
def _drive_ledger(mod, seed: int, capacity: int):
    clock = iter(1000.0 + 0.25 * i for i in range(10_000))
    ledger = mod.EventLedger(mod.EventLedgerConfig(capacity=capacity),
                             host="h1", clock=lambda: next(clock))
    rng = np.random.default_rng(seed)
    kinds = sorted(mod.KINDS)
    for i in range(40):
        kind = kinds[int(rng.integers(0, len(kinds)))]
        ledger.emit(kind, severity=("info", "warn", "error")[i % 3],
                    request_id=f"r{i}" if i % 2 else None,
                    tenant="t" if i % 5 == 0 else None, cause="c",
                    n=i, ratio=float(rng.random()))
    return ledger


@pytest.mark.parametrize("capacity", [8, 4096])
def test_event_ledgers_write_and_parse_the_same_jsonl(capacity):
    jax_l = _drive_ledger(jax_events, 5, capacity)
    port_l = _drive_ledger(port_events, 5, capacity)
    assert jax_l.state() == port_l.state()
    for kw in ({}, {"n": 3}, {"since": 1005.0}, {"kind": "fault.trip"}):
        text = port_l.to_jsonl(**kw)
        assert text == jax_l.to_jsonl(**kw)
        assert port_events.parse_events(text) == \
            jax_events.parse_events(text)


@pytest.mark.parametrize("bad", [("no.such_kind", "info"),
                                 ("fault.trip", "loud")])
def test_event_ledgers_refuse_unknown_kinds_and_severities(bad):
    kind, severity = bad
    for mod in (jax_events, port_events):
        with pytest.raises(ValueError):
            mod.EventLedger().emit(kind, severity=severity)
        assert mod.NO_EVENTS.emit(kind) is None      # disabled: a no-op
    assert port_events.KINDS == jax_events.KINDS


@pytest.mark.parametrize("text", [
    '{"format": "gofr-workload", "version": 1}\n',
    '{"format": "gofr-events", "version": 2}\n', "",
    '{"format": "gofr-events", "version": 1}\n{"kind": "x"}\n'])
def test_parse_events_refuses_what_jax_refuses(text):
    for mod in (jax_events, port_events):
        with pytest.raises(ValueError):
            mod.parse_events(text)


def test_resolve_ledger_reads_the_same_switches(monkeypatch):
    for value in (False, True, None, port_events.EventLedgerConfig(0)):
        got = port_events.resolve_ledger(value)
        assert got.enabled == (value is not False and not (
            isinstance(value, port_events.EventLedgerConfig)))
    monkeypatch.setenv("GOFR_EVENTS", "off")
    assert port_events.resolve_ledger(None) is port_events.NO_EVENTS
    assert jax_events.resolve_ledger(None) is jax_events.NO_EVENTS


# ------------------------------------------------------------- goodput
def _drive_goodput(mod, seed: int):
    g = mod.GoodputMeter()
    rng = np.random.default_rng(seed)
    t = 0.0
    for _ in range(300):
        op = int(rng.integers(0, 6))
        busy = float(rng.random() * 0.05)
        if op == 0:
            g.add_decode(busy, int(rng.integers(0, 9)), 8)
        elif op == 1:
            group = int(rng.choice([1, 2, 4, 8]))
            fresh = int(rng.integers(0, group + 1))
            g.add_prefill(("prefill", "prefill_chunk")[op % 2], busy, group,
                          fresh, int(rng.integers(0, group - fresh + 2)))
        elif op == 2:
            rows = [(int(d), int(rng.integers(0, d + 2)))
                    for d in rng.integers(0, 9, size=int(rng.integers(0, 9)))]
            g.add_spec(busy, 8, rows)
        elif op == 3:
            g.reprice_probe(float(rng.random() * 0.01))
        elif op == 4:
            t += float(rng.random() * 0.01)
            g.note_pass_end(t, bool(rng.integers(0, 2)))
        else:
            t += float(rng.random() * 0.01)
            g.note_dispatch(t)
    return g


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_goodput_meters_classify_and_conserve_alike(seed):
    jax_g, port_g = _drive_goodput(jax_obs, seed), _drive_goodput(port_obs,
                                                                  seed)
    assert port_g.state() == jax_g.state()
    assert port_g.summary() == jax_g.summary()
    total = port_g.useful_s + sum(port_g.waste_s.values())
    assert abs(total - port_g.busy_s) <= 1e-12 * max(1.0, port_g.busy_s)
    assert port_g.state()["conservation_error_s"] == 0.0


# ---------------------------------------------------------- cost model
def _drive_costs(mod, seed: int):
    costs = mod.CostModel(alpha=0.2, baseline_passes=8, drift_ratio=2.0,
                          drift_sigma=6.0, max_signatures=4)
    rng = np.random.default_rng(seed)
    drifts = []
    sigs = ["decode/0", "prefill/64/1", "chunk/1024/1/None",
            "spec_verify/8", "decode/0/int8"]
    for i in range(120):
        # the first four signatures are tracked, the fifth overflows
        sig = sigs[i] if i < 4 else sigs[int(rng.integers(0, len(sigs)))]
        skew = 0.0
        if i in (60, 61, 90):            # the planted drift
            sig, skew = "decode/0", 1.0
        drifts.append(costs.observe(sig.split("/")[0], sig,
                                    0.02 + float(rng.random()) * 0.002,
                                    rows=int(rng.integers(1, 9)),
                                    tokens=int(rng.integers(0, 64)),
                                    skew_s=skew))
    return costs, drifts


@pytest.mark.parametrize("seed", [2, 3])
def test_cost_models_seal_and_drift_alike(seed):
    (jax_c, jax_d), (port_c, port_d) = _drive_costs(jax_costmodel, seed), \
        _drive_costs(port_costmodel, seed)
    assert port_d == jax_d
    assert port_c.state() == jax_c.state()
    assert port_c.by_kind() == jax_c.by_kind()
    # the skew opened at least one decode episode, counted once each
    assert 1 <= port_c.drift_episodes == sum(d is not None for d in port_d)
    port_c.reset()
    assert port_c.state()["signatures"] == {}


# -------------------------------------------------- SLO, usage, window
def _drive_slo(mod, seed: int):
    tracker = mod.SLOTracker(mod.SLOConfig(windows=(60.0, 600.0),
                                           budget_window_s=3600.0,
                                           max_events=64))
    rng = np.random.default_rng(seed)
    verdicts = []
    t = 5000.0
    for _ in range(300):
        t += float(rng.random() * 5.0) - 0.5     # some out of order
        err = "boom" if rng.random() < 0.02 else None
        good = tracker.judge(error=err, ttft_s=float(rng.random() * 3.0),
                             tpot_s=float(rng.random() * 0.6),
                             e2e_s=float(rng.random() * 40.0))
        verdicts.append(good)
        tracker.record(good, t=t)
    return tracker, verdicts, t


@pytest.mark.parametrize("seed", [1, 4])
def test_slo_trackers_burn_alike(seed, monkeypatch):
    (jax_t, jax_v, t), (port_t, port_v, _) = _drive_slo(jax_obs, seed), \
        _drive_slo(port_obs, seed)
    monkeypatch.setattr(time, "time", lambda: t + 1.0)
    assert port_v == jax_v
    assert port_t.state() == jax_t.state()


def _drive_usage(mod, seed: int, now: float):
    ledger = mod.UsageLedger(window_records=32)
    rng = np.random.default_rng(seed)
    for i in range(80):
        ledger.record(tenant=["a", "b", "anonymous"][i % 3],
                      status=["ok", "error", "cancelled"][int(rng.integers(0, 3))],
                      prompt_tokens=int(rng.integers(1, 900)),
                      completion_tokens=int(rng.integers(0, 64)),
                      queue_s=float(rng.random()), e2e_s=float(rng.random()),
                      device_s=float(rng.random() * 0.1),
                      waste_recompute_s=float(rng.random() * 0.01),
                      waste_spec_s=float(rng.random() * 0.01),
                      t=now - 400.0 + 5.0 * i)
    return ledger


@pytest.mark.parametrize("query", [{}, {"tenant": "a"},
                                   {"window_s": 60.0},
                                   {"window_s": 300.0, "tenant": "b"}])
def test_usage_ledgers_roll_up_alike(query, monkeypatch):
    now = 90000.0
    monkeypatch.setattr(time, "time", lambda: now)
    assert _drive_usage(port_obs, 6, now).rollup(**query) == \
        _drive_usage(jax_obs, 6, now).rollup(**query)


@pytest.mark.parametrize("spec", ["5m", "1h", "30s", "300", "2d", "", None,
                                  "banana", "m"])
def test_parse_window_alike(spec):
    got = []
    for mod in (jax_obs, port_obs):
        try:
            got.append(mod.parse_window(spec))
        except ValueError:
            got.append("ValueError")
    assert got[0] == got[1]


def test_watermarks_and_the_recompile_sentinel_alike():
    out = []
    for mod in (jax_obs, port_obs):
        wm = mod.WatermarkTracker()
        for i, v in enumerate([3, 2, 5, 5, 5.2, 9, 1]):
            wm.update("kv_pages", float(v), t=100.0 + i)
        sentinel = mod.RecompileSentinel()
        for sig in [("prefill", 64, 1), ("decode", 0)]:
            sentinel.observe(sig)
        fresh = [sentinel.dispatch(("decode", 0))]
        sentinel.seal()
        fresh += [sentinel.dispatch(s) for s in
                  [("decode", 0), ("chunk", 16, 4, None),
                   ("chunk", 16, 4, None), ("spec_verify", 8, "int8")]]
        out.append((wm.state(), wm.get("kv_pages"), sentinel.state(), fresh))
    assert out[0] == out[1]


# ------------------------------------------------------------ integrity
class _Params:
    def __init__(self, temperature, top_p, top_k, max_new_tokens):
        self.temperature, self.top_p = temperature, top_p
        self.top_k, self.max_new_tokens = top_k, max_new_tokens


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_request_digests_are_equal(seed):
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, 128256, size=int(rng.integers(1, 300))).tolist()
    tokens = rng.integers(0, 128256, size=int(rng.integers(0, 64))).tolist()
    params = _Params(float(rng.choice([0.0, 0.7, 1e-5])),
                     float(rng.random()), int(rng.integers(0, 64)),
                     int(rng.integers(1, 512)))
    logprobs = rng.normal(size=int(rng.integers(0, 4))).tolist()
    assert port_integrity.request_digest(prompt, params, tokens,
                                         logprobs=logprobs) == \
        jax_integrity.request_digest(prompt, params, tokens,
                                     logprobs=logprobs)
    assert port_integrity.DIGEST_VERSION == jax_integrity.DIGEST_VERSION


class _Req:
    def __init__(self, prompt, generated, probe="", expected=""):
        self.prompt_tokens, self.generated = prompt, generated
        self.params = _Params(0.0, 1.0, 0, 16)
        self.probe, self.probe_expected = probe, expected
        self.error, self.cancelled, self.digest = None, False, None


def _records(seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(6):
        prompt = rng.integers(0, 256, size=5 + i).tolist()
        out.append({"prompt_tokens": prompt,
                    "params": {"temperature": 0.0 if i != 2 else 0.7,
                               "top_p": 1.0, "top_k": 0,
                               "max_new_tokens": 16},
                    "digest": None if i == 4 else f"{i:032x}"})
    return out


@pytest.mark.parametrize("writer", BOTH)
def test_golden_sets_written_by_either_package_load_in_both(writer,
                                                            tmp_path):
    mod = jax_integrity if writer == "jax" else port_integrity
    path = tmp_path / "golden.jsonl"
    mod.GoldenSet.seal(_records(0), limit=3).save(str(path))
    loaded = [m.GoldenSet.load(str(path)) for m in (jax_integrity,
                                                    port_integrity)]
    assert loaded[0].to_jsonl() == loaded[1].to_jsonl() == \
        path.read_text()
    assert len(loaded[1]) == 3            # the sampled and digestless skip
    assert len(port_integrity.GoldenSet.load(str(path), limit=2)) == 2


def test_golden_set_load_refuses_a_foreign_corpus(tmp_path):
    path = tmp_path / "bad.jsonl"
    path.write_text('{"format": "gofr-golden", "version": 1, '
                    '"digest_version": 2, "count": 0}\n')
    for mod in (jax_integrity, port_integrity):
        with pytest.raises(ValueError):
            mod.GoldenSet.load(str(path))


def test_integrity_planes_judge_probes_alike(tmp_path):
    path = tmp_path / "golden.jsonl"
    jax_integrity.GoldenSet.seal(_records(1)).save(str(path))
    states = []
    for mod in (jax_integrity, port_integrity):
        golden = mod.GoldenSet.load(str(path))
        plane = mod.IntegrityPlane(golden=golden, probe_passes=2,
                                   rearm_probes=2)
        results = []
        rng = np.random.default_rng(9)
        for i in range(40):
            entry = plane.note_pass()
            if entry is None:
                results.append(plane.fold(_Req([1, 2, 3], [i])))
                continue
            digest = mod.request_digest(entry.prompt_tokens,
                                        _Params(0.0, 1.0, 0, 16), [7, 8])
            # the corpus' digests are synthetic: a probe matches when its
            # expectation is set to the digest it will fold to
            expected = digest if rng.random() < 0.6 else entry.digest
            results.append(plane.fold(_Req(entry.prompt_tokens, [7, 8],
                                           probe=entry.id,
                                           expected=expected)))
        states.append((plane.state(), plane.summary(), results))
    assert states[0] == states[1]
    assert states[1][0]["episodes"] >= 1


# ------------------------------------------------------------ MFU basis
@pytest.mark.parametrize("tied", [True, False])
def test_decode_flops_formula_matches_the_flop_counter(tied):
    # the hand-written kernels are opaque to FlopCounterMode, so the
    # formula is held against it over the plain step on the CPU
    c = LlamaConfig.tiny().scaled(tie_embeddings=tied)
    gen = torch.Generator().manual_seed(0)
    params = llama_init(c, gen, "cpu")
    b, pg, n_pages = 3, 16, 24
    mp = c.max_seq // pg
    k_pool, v_pool = make_pool(c, n_pages, pg, "cpu", "bf16")
    tables = torch.arange(b * mp, dtype=torch.int32).reshape(b, mp) % n_pages
    lengths = torch.tensor([3, 40, 100], dtype=torch.int32)
    tokens = torch.tensor([1, 2, 3])
    with FlopCounterMode(display=False) as counter:
        llama_decode_step_paged(params, tokens, k_pool, v_pool, tables,
                                lengths, c, implementation="plain")
    assert counter.get_total_flops() == b * llama_decode_flops(c, mp * pg)


def test_device_peak_flops_by_card_name(monkeypatch):
    assert port_obs.device_peak_flops("cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, peak in (("NVIDIA H100 80GB HBM3", 989e12),
                       ("NVIDIA GeForce RTX 4090", None)):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda dev=None, name=name: name)
        assert port_obs.device_peak_flops("cuda") == peak
