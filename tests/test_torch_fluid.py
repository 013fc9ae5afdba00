"""PyTorch port vs JAX reference: the fluid traffic plane (net/fluid.py;
kernels K14-K16 and fluid-on K11, run here through their plain versions).

Functions, on numpy-seeded random inputs (`shadow_tpu_torch.testing.
fluid_case`: K up to 64 classes, N up to 256 links, zero-demand and
past-window classes, links over capacity, an empty window, the done-round):
`fluid_advance`, `fluid_host_effects`, the foreground fold
(`_fluid_fg_link_bytes`, affine and node_of routes) and the counter draw
`fluid_send_uniform` against the JAX package's; the exact f64 FMA the plain
versions use against rational arithmetic.

The slice: tgen-TCP at K = 1 on the flat queue and at K = 4 on the bucketed
queue under tests/test_fluid.py's CONGESTED_FLUID schedule (a class whose
source zone is its destination zone: charge 2), once with loss_max 0.3 so
the counter draw runs, and phold and udp_echo at K = 1; each port run
continues the JAX package's t = 0 state and must end in the JAX final
state. Through the YAML driver, tgen on a 2x2 torus with the affine host ->
link map and with an irregular one, report and heartbeat included. A
zero-demand fluid block equals fluid-off in the port; the options parse,
validate and compile as in the JAX package.

Tolerance: exact equality everywhere — digests, events, every drop counter,
`fl_bg_bytes`, `fl_bg_dropped`, `rates` and `link_util` (f64 compared by
value, f32 by bits). The JAX references are computed once per module.
"""

from __future__ import annotations

import collections
import io
import json
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from engine_harness import build_sim, mk_hosts
from shadow_tpu.config.options import ConfigError as JaxConfigError
from shadow_tpu.config.options import FluidOptions as JaxFluidOptions
from shadow_tpu.config.options import load_config as jax_load_config
from shadow_tpu.core import Engine as JaxEngine
from shadow_tpu.core.engine import _fluid_fg_link_bytes as jax_fg_link_bytes
from shadow_tpu.net import fluid as jfl
from shadow_tpu.sim import Simulation as JaxSimulation
from shadow_tpu_torch.config.options import ConfigError, FluidOptions, load_config
from shadow_tpu_torch.core.convert import engine_config_from, params_from_jax_numpy, to_numpy
from shadow_tpu_torch.core.engine import Engine, EngineConfig
from shadow_tpu_torch.models import get_model
from shadow_tpu_torch.net import fluid as pfl
from shadow_tpu_torch.sim import Simulation
from shadow_tpu_torch.testing import fluid_case

# tests/test_fluid.py's schedules
CONGESTED_FLUID = {
    "link_capacity": "50 Mbit",
    "latency_factor_max": 1.2,
    "util_threshold": 0.5,
    "classes": [{"src_zone": 0, "dst_zone": 0, "rate": "100 Mbit", "start": 0}],
}
ZERO_FLUID = {
    "link_capacity": "1 Gbit",
    "latency_factor_max": 1.5,
    "loss_max": 0.2,
    "classes": [{"src_zone": 0, "dst_zone": 0, "rate": "100 Mbit", "start": "1000 s"}],
}
WORKLOADS = {
    "phold": ("phold", mk_hosts(8, {"mean_delay": "20 ms", "population": 3}),
              300_000_000, dict(loss=0.1)),
    "echo": ("udp_echo",
             [dict(host_id=0, name="server", start_time=0, model_args={"role": "server"})]
             + [dict(host_id=i, name=f"c{i}", start_time=0,
                     model_args={"role": "client", "peer": "server",
                                 "interval": "4 ms", "size_bytes": 2000})
                for i in range(1, 5)],
             200_000_000, dict(bw_bits=2_000_000, loss=0.05)),
    "tgen": ("tgen_tcp",
             mk_hosts(5, {"flow_segs": 8, "flows": 2, "cwnd_cap": 8, "rto_min": "100 ms"}),
             2_000_000_000, dict(loss=0.05, latency=10_000_000, sends_budget=16)),
}
# (workload, K, queue block, loss_max)
SLICE = {
    "tgen-flat-k1": ("tgen", 1, 0, 0.0),
    "tgen-bucketed-k4": ("tgen", 4, 8, 0.0),
    "tgen-flat-k1-loss": ("tgen", 1, 0, 0.3),
    "phold-flat-k1": ("phold", 1, 0, 0.0),
    "echo-flat-k1": ("echo", 1, 0, 0.0),
}
# class counts whose sums the port holds to XLA-CPU's order (net/fluid.py)
K_VALUES = [1, 2, 4, 5, 17, 27, 33, 48, 64]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors: PyTorch's intra-op threads only add overhead here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _jax_fp(fp):
    return jfl.FluidParams(*(jnp.asarray(_np(x)) for x in fp))


# ---------------------------------------------------------------- functions

AdvCfg = collections.namedtuple("AdvCfg", "fluid_links fluid_tau_ns")
FxCfg = collections.namedtuple(
    "FxCfg", "fluid_links fluid_util_threshold fluid_loss_max fluid_lat_max_x1000")
FgCfg = collections.namedtuple("FgCfg", "fluid_links num_hosts hosts_per_node")
_jax_advance = jax.jit(jfl.fluid_advance, static_argnums=0)
_jax_effects = jax.jit(jfl.fluid_host_effects, static_argnums=0)


@pytest.mark.parametrize("k", K_VALUES)
def test_fluid_advance_matches_jax(k):
    """One ODE step: rates, link_util and the carried/dropped byte deltas,
    over links counts up to 256, an empty window and the done-round."""
    for i, (n, dt_zero, done) in enumerate(((256, False, False), (7, False, False),
                                            (100, True, False), (13, False, True))):
        c = fluid_case(1000 * k + i, 16, n, k, "cpu", dt_zero=dt_zero, done=done)
        cfg, st = c["cfg"], c["st"]
        jst, jd, jr = _jax_advance(
            AdvCfg(n, cfg.fluid_tau_ns), _jax_fp(c["fp"]),
            jfl.FluidState(jnp.asarray(_np(st.rates)), jnp.asarray(_np(st.link_util))),
            jnp.asarray(_np(c["fg"])), jnp.int64(c["now"]), jnp.int64(c["window_end"]),
            jnp.bool_(done))
        pst, pb, pd = pfl.fluid_advance(cfg, c["fp"], st, c["fg"], c["now"], c["window_end"],
                                        done, c["bg_bytes"], c["bg_dropped"])
        np.testing.assert_array_equal(_np(pst.rates), np.asarray(jst.rates))
        np.testing.assert_array_equal(_np(pst.link_util), np.asarray(jst.link_util))
        assert int(pb - c["bg_bytes"]) == int(jd)
        assert int(pd - c["bg_dropped"]) == int(jr)
        if not (dt_zero or done):
            assert not np.array_equal(_np(pst.rates), _np(st.rates))


@pytest.mark.parametrize("k", K_VALUES)
def test_fluid_host_effects_matches_jax(k):
    """Per-host loss (f32, by bits) and latency x1000 from the previous
    state, affine and irregular host -> link maps."""
    lats = []
    for i, (n, affine) in enumerate(((256, True), (5, False), (3, True), (40, True),
                                     (2, False), (1, True))):
        c = fluid_case(2000 * k + i, 64, n, k, "cpu", affine=affine)
        cfg, st = c["cfg"], c["st"]
        nodes = pfl.host_nodes(cfg, c["node_of"], cfg.num_hosts)
        jl, jt = _jax_effects(
            FxCfg(n, cfg.fluid_util_threshold, cfg.fluid_loss_max, cfg.fluid_lat_max_x1000),
            _jax_fp(c["fp"]),
            jfl.FluidState(jnp.asarray(_np(st.rates)), jnp.asarray(_np(st.link_util))),
            jnp.asarray(_np(nodes).astype(np.int32)))
        pl, pt = pfl.fluid_host_effects(cfg, c["fp"], st, c["node_of"])
        np.testing.assert_array_equal(_np(pl).view(np.int32), np.asarray(jl).view(np.int32))
        np.testing.assert_array_equal(_np(pt), np.asarray(jt))
        lats.append(_np(pt))
    lats = np.concatenate(lats)
    assert (lats > 1000).any() and (lats == 1000).any()


@pytest.mark.parametrize("affine", [True, False], ids=["affine", "node_of"])
def test_fg_link_bytes_matches_jax(affine):
    """The foreground fold of the pre-exchange outbox (both routes of the
    host -> link map, out-of-range destinations clipped)."""
    for seed, n in ((1, 3), (2, 16), (3, 256)):
        c = fluid_case(seed, 64, n, 4, "cpu", affine=affine)
        cfg = c["cfg"]
        ob = collections.namedtuple("Ob", "t payload dst")(
            jnp.asarray(_np(c["ob_t"])), jnp.asarray(_np(c["ob_payload"])),
            jnp.asarray(_np(c["ob_dst"])))
        params = collections.namedtuple("P", "node_of")(jnp.asarray(_np(c["node_of"])))
        want = jax_fg_link_bytes(FgCfg(n, cfg.num_hosts, cfg.hosts_per_node), None, ob, params,
                                 jnp.arange(cfg.num_hosts, dtype=jnp.int32))
        got = pfl.fluid_fg_link_bytes(cfg, c["ob_dst"], c["ob_t"], c["ob_payload"],
                                      c["node_of"])
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_fluid_send_uniform_matches_jax():
    r = np.random.default_rng(5)
    for seed in (0, 1, (1 << 63) + 12345, int(r.integers(0, 1 << 62))):
        hosts = r.integers(0, 1 << 20, 4096)
        ctr = r.integers(0, 1 << 40, 4096)
        want = jfl.fluid_send_uniform(seed, jnp.asarray(hosts), jnp.asarray(ctr))
        got = pfl.fluid_send_uniform(seed, torch.as_tensor(hosts), torch.as_tensor(ctr))
        np.testing.assert_array_equal(_np(got).view(np.int32), np.asarray(want).view(np.int32))


def test_fma_f64_is_exactly_rounded():
    """The plain versions' FMA against rational arithmetic, on random and on
    cancelling operands (c near -a*b, the hard cases)."""
    r = np.random.default_rng(9)
    n = 3000
    a = r.standard_normal(n) * 10.0 ** r.integers(-8, 9, n)
    b = r.standard_normal(n) * 10.0 ** r.integers(-8, 9, n)
    p = a * b
    c = np.concatenate([r.standard_normal(n // 3) * 10.0 ** r.integers(-12, 12, n // 3),
                        -p[n // 3: 2 * n // 3],
                        -p[2 * n // 3:] + np.spacing(p[2 * n // 3:]) * r.integers(-3, 4, n - 2 * (n // 3)) / 2])
    got = pfl.fma_f64(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(c)).numpy()
    want = [float(Fraction(x) * Fraction(y) + Fraction(z)) for x, y, z in zip(a, b, c)]
    np.testing.assert_array_equal(got, np.array(want))


@pytest.mark.parametrize("k", [28, 30, 32, 65])
def test_unsupported_class_counts_are_refused(k):
    """Class counts whose sums the port does not reproduce raise, at the
    config and at the engine config."""
    opts = FluidOptions.from_dict({"classes": [{"rate": "1 Mbit"}] * k})
    with pytest.raises(ValueError, match="fluid classes"):
        pfl.compile_fluid(opts, num_links=1)
    with pytest.raises(ValueError, match="fluid classes"):
        EngineConfig(num_hosts=4, stop_time=1, fluid_classes=k, fluid_links=1)


# ---------------------------------------------------------------- the slice


def _jax_run(name, fluid):
    """The JAX engine's t = 0 params/state and final state of a SLICE case."""
    work, k, qb, loss_max = SLICE[name]
    model, hosts, stop, kw = WORKLOADS[work]
    fl = None if fluid is None else {**fluid, "loss_max": loss_max}
    cfg, m, params, mstate, events = build_sim(model, hosts, stop, microstep_events=k,
                                               queue_block=qb, fluid=fl, **kw)
    eng = JaxEngine(cfg, m, None)
    st, par = eng.init_state(params, mstate, events, seed=1)
    chunks = 0
    while not bool(st.done):
        st = eng.run_chunk(st, par)
        chunks += 1
        assert chunks < 500
    return eng.cfg, jax.tree.map(np.array, jax.device_get(params)), \
        jax.tree.map(np.array, jax.device_get(st))


@pytest.fixture(scope="module")
def jax_refs():
    """Each slice case's JAX run, computed once."""
    return {name: _jax_run(name, CONGESTED_FLUID) for name in SLICE}


def _port_run(jcfg, jparams, work):
    model, hosts, _, _ = WORKLOADS[work]
    eng = Engine(engine_config_from(jcfg), get_model(model)(), "cpu")
    mparams, mstate, events = eng.model.build(hosts, 1, "cpu")
    p0 = params_from_jax_numpy(jparams, device="cpu")._replace(model=mparams)
    st, par = eng.init_state(p0, mstate, events, seed=1)
    while not st.done:
        st = eng.run_chunk(st, par)
    return st


@pytest.mark.parametrize("name", list(SLICE))
def test_fluid_run_matches_jax(name, jax_refs):
    """The whole run under CONGESTED_FLUID: the port's final state equals
    the JAX package's, lane for lane (digests, events, every drop counter,
    fl_bg_bytes/fl_bg_dropped, rates, link_util, queues, RNG, model)."""
    jcfg, jparams, jst = jax_refs[name]
    st = _port_run(jcfg, jparams, SLICE[name][0])
    a, b = to_numpy(jst), to_numpy(st)
    assert a.keys() == b.keys()
    bad = [key for key in a if not np.array_equal(a[key], b[key])]
    assert not bad, bad
    assert int(b["stats.fl_bg_bytes"]) > 0 and int(b["stats.fl_bg_dropped"]) > 0
    if SLICE[name][3] > 0:  # the counter draw dropped packets into pkts_lost
        off = jax_refs["tgen-flat-k1"][2]
        assert int(b["stats.pkts_lost"].sum()) > int(np.asarray(off.stats.pkts_lost).sum())


@pytest.mark.parametrize("k,qb", [(1, 0), (4, 8)], ids=["flat-k1", "bucketed-k4"])
def test_zero_demand_equals_fluid_off(k, qb):
    """A class whose window opens past the horizon leaves every digest,
    event count and drop counter of the port as with no fluid block."""
    model, hosts, stop, kw = WORKLOADS["tgen"]
    out = []
    for fluid in (None, ZERO_FLUID):
        jcfg, _, params, _, _ = build_sim(model, hosts, stop, microstep_events=k,
                                          queue_block=qb, fluid=fluid, **kw)
        st = _port_run(jcfg, jax.tree.map(np.array, jax.device_get(params)), "tgen")
        out.append(to_numpy(st))
    off, on = out
    assert int(on["stats.fl_bg_bytes"]) == 0 and not on["fluid.rates"].any()
    for key in off:
        np.testing.assert_array_equal(off[key], on[key], err_msg=key)


TORUS_YAML = """
general: {stop_time: 1500 ms, seed: 3, heartbeat_interval: 500 ms}
network:
  graph:
    type: gml
    inline: |
      graph [
        directed 0
        node [ id 0 host_bandwidth_down "1 Gbit" host_bandwidth_up "1 Gbit" ]
        node [ id 1 host_bandwidth_down "1 Gbit" host_bandwidth_up "1 Gbit" ]
        node [ id 2 host_bandwidth_down "1 Gbit" host_bandwidth_up "1 Gbit" ]
        node [ id 3 host_bandwidth_down "1 Gbit" host_bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "10 ms" ]
        edge [ source 1 target 1 latency "10 ms" ]
        edge [ source 2 target 2 latency "10 ms" ]
        edge [ source 3 target 3 latency "10 ms" ]
        edge [ source 0 target 1 latency "10 ms" ]
        edge [ source 1 target 3 latency "10 ms" ]
        edge [ source 3 target 2 latency "10 ms" ]
        edge [ source 2 target 0 latency "10 ms" ]
      ]
experimental: {event_queue_capacity: 28, sends_per_host_round: 24, rounds_per_chunk: 16}
fluid:
  link_capacity: 20 Mbit
  latency_factor_max: 1.5
  util_threshold: 0.5
  classes:
    - {src_zone: 1, dst_zone: 0, rate: 15 Mbit, start: 200 ms}
    - {src_zone: 2, dst_zone: 0, rate: 15 Mbit, start: 400 ms, end: 1 s}
    - {src_zone: 3, dst_zone: 3, rate: 30 Mbit, start: 0}
"""


def _torus(counts, k, qb, loss_max):
    d = yaml.safe_load(TORUS_YAML)
    d["experimental"]["microstep_events"] = k
    if qb:
        d["experimental"]["event_queue_block"] = qb
    d["fluid"]["loss_max"] = loss_max
    d["hosts"] = {f"n{i}": {"count": c, "network_node_id": i, "processes": [{
        "model": "tgen_tcp",
        "model_args": {"flows": 2, "flow_segs": 10, "cwnd_cap": 8, "mss": 1460,
                       "flow_gap": "20 ms", "tx_batch": 2}}]} for i, c in enumerate(counts)}
    return yaml.safe_dump(d)


@pytest.mark.parametrize("counts,k,qb,loss_max", [
    ((4, 4, 4, 4), 1, 7, 0.3),
    ((3, 5, 4, 4), 1, 0, 0.0),
], ids=["affine-bucketed-loss", "node_of-flat"])
def test_yaml_run_matches_jax(counts, k, qb, loss_max):
    """Through the drivers on a 2x2 torus: the report (fluid block
    included), the final fluid state and the heartbeat's bg= field equal
    the JAX package's, with the host -> link map affine (uniform blocks) or
    irregular."""
    text = _torus(counts, k, qb, loss_max)
    plog, jlog = io.StringIO(), io.StringIO()
    psim = Simulation(load_config(text, is_text=True), device="cpu")
    assert (psim.engine_cfg.hosts_per_node > 0) == (len(set(counts)) == 1)
    prep = psim.run(progress=False, log=plog)
    jsim = JaxSimulation(jax_load_config(text, is_text=True), world=1)
    jrep = jsim.run(progress=False, log=jlog)
    keys = ("determinism_digest", "events_processed", "rounds", "packets_sent",
            "packets_delivered", "packets_lost", "packets_unreachable", "packets_codel_dropped",
            "queue_overflow_dropped", "packets_budget_dropped", "outbox_overflow_dropped",
            "monotonic_violations", "model_report", "fluid")
    assert {key: prep[key] for key in keys} == {key: jrep[key] for key in keys}
    assert prep["fluid"]["bg_bytes"] > 0 and prep["fluid"]["bg_dropped"] > 0
    jfluid = jax.device_get(jsim.state.fluid)
    np.testing.assert_array_equal(_np(psim.state.fluid.rates), np.asarray(jfluid.rates))
    np.testing.assert_array_equal(_np(psim.state.fluid.link_util),
                                  np.asarray(jfluid.link_util))

    def bg(log):
        return [ln.split("bg=")[1].split()[0] for ln in log.getvalue().splitlines()
                if ln.startswith("[heartbeat]")]

    assert bg(plog) and bg(plog) == bg(jlog)


def test_cli_writes_the_fluid_block(tmp_path):
    """`python -m shadow_tpu_torch` on a fluid config: `--device cpu` runs
    it and sim-stats.json carries the fluid block in the JAX package's
    shape; without it the CLI asks for a CUDA device (none here)."""
    from shadow_tpu_torch.__main__ import main as port_main

    path = tmp_path / "fluid.yaml"
    path.write_text(_torus((4, 4, 4, 4), 1, 0, 0.0).replace("1500 ms", "600 ms"))
    data = tmp_path / "data"
    assert port_main([str(path), "--device", "cpu", f"--general.data_directory={data}"]) == 0
    rep = json.loads((data / "sim-stats.json").read_text())
    want = jfl.assemble_fluid_report(
        stats=collections.namedtuple("S", "fl_bg_bytes fl_bg_dropped")(np.int64(1), np.int64(2)),
        fluid_state=jfl.FluidState(np.zeros(3), np.zeros(4)),
        cfg=collections.namedtuple("C", "fluid_classes fluid_links fluid_loss_max "
                                   "fluid_lat_max_x1000")(3, 4, 0.0, 1500))
    assert rep["fluid"].keys() == want.keys() and rep["fluid"]["links"] == 4
    if not torch.cuda.is_available():
        assert port_main([str(path), f"--general.data_directory={data}"]) == 1


FLUID_OPTION_CASES = [
    {},
    {"classes": [{"rate": "1 Gbit"}]},
    {"link_capacity": "2 Gbit", "tau": 20, "util_threshold": 0.5, "loss_max": 0.3,
     "latency_factor_max": 1.5, "seed": 9,
     "classes": [{"name": "a", "src_zone": 1, "dst_zone": 0, "rate": "1500 Mbit",
                  "start": "5 s", "end": "9 s"}]},
    {"link_capacity": 0},
    {"tau": 0},
    {"util_threshold": 1.0},
    {"loss_max": 1.5},
    {"latency_factor_max": 0.5},
    {"bogus": 1},
    {"classes": [{"src_zone": 0}]},
    {"classes": [{"rate": 0}]},
    {"classes": [{"rate": "1 Mbit", "start": 5, "end": 2}]},
    {"classes": [{"rate": "1 Mbit", "color": "red"}]},
]


@pytest.mark.parametrize("case", range(len(FLUID_OPTION_CASES)))
def test_fluid_options_and_compile_match_jax(case):
    """The block parses, validates (the same error text) and compiles onto
    the links as in the JAX package."""
    d = FLUID_OPTION_CASES[case]
    try:
        jopts = JaxFluidOptions.from_dict(d)
    except JaxConfigError as e:
        with pytest.raises(ConfigError) as got:
            FluidOptions.from_dict(d)
        assert str(got.value) == str(e)
        return
    opts = FluidOptions.from_dict(d)
    assert vars(opts) | {"classes": None} == vars(jopts) | {"classes": None}
    assert [vars(c) for c in opts.classes] == [vars(c) for c in jopts.classes]
    want = jfl.compile_fluid(jopts, num_links=3, default_seed=7)
    got = pfl.compile_fluid(opts, num_links=3, default_seed=7)
    for f in ("classes", "links", "tau_ns", "util_threshold", "loss_max", "lat_max_x1000",
              "seed"):
        assert getattr(got, f) == getattr(want, f), f
    assert (got.params is None) == (want.params is None)
    if got.params is not None:
        for f in pfl.FluidParams._fields:
            np.testing.assert_array_equal(_np(getattr(got.params, f)),
                                          np.asarray(getattr(want.params, f)))
    with pytest.raises(ValueError, match="out of range"):
        pfl.compile_fluid(FluidOptions.from_dict({"classes": [{"src_zone": 3, "rate": 1}]}),
                          num_links=3)
