"""PyTorch port vs JAX reference: the integrity sentinel (B15).

Bench config 10 (`shadow_tpu_torch.testing.cfg10_config`: tgen-TCP on a
torus with `integrity: {enabled: true}`) at 32 hosts on a 2 x 2 torus, cut
to 2 sim-s, on a bucketed queue, and 40 PHOLD hosts on the timer wheel
with the sentinel on, through both packages' `Simulation`: the reports
must agree (the `integrity{}` block with `determinism_digest2` included),
and so must the final state's sentinel lanes (`integrity`, `iv_mask`,
`iv_round`, `digest2`). Then the
JAX package's replay drill on 8 PHOLD hosts: a one-shot scribble of queue
slot (0, 0) at round 16 is replayed and survived (one transient, one
replay, both digests of the clean run), and a scribble on every attempt
raises `IntegrityAbort` naming the same invariant and round as the JAX
package, with the last good state reported. Each JAX reference runs once
per module. Last, each of the port's guards trips on its own crafted
violation (port only), and the helpers equal the JAX package's.

Tolerance: exact equality everywhere.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.config.options import ConfigOptions as JaxConfigOptions
from shadow_tpu.core import integrity as jax_integrity
from shadow_tpu.sim import Simulation as JaxSimulation
from shadow_tpu_torch.config.options import ConfigOptions
from shadow_tpu_torch.core import integrity
from shadow_tpu_torch.core.convert import to_numpy
from shadow_tpu_torch.sim import Simulation
from shadow_tpu_torch.testing import cfg10_config, scribble_hook

_NOT_RESULTS = ("wall_seconds", "sim_wall_ratio", "ici_bytes", "device", "host_syncs",
                "kernel_launches")
_LANES = ("stats.integrity", "stats.iv_mask", "stats.iv_round", "stats.digest2",
          "stats.digest")

# the JAX package's driver drill (tests/test_integrity.py), 8 PHOLD hosts
DRILL = {
    "general": {"stop_time": "2 s", "seed": 1, "heartbeat_interval": None},
    "experimental": {"event_queue_capacity": 32, "rounds_per_chunk": 8},
    "integrity": {"enabled": True},
    "hosts": {"node": {"count": 8, "network_node_id": 0, "processes": [{
        "model": "phold",
        "model_args": {"population": 2, "mean_delay": "100 ms", "size_bytes": 64}}]}},
}
RUNS = {
    "cfg10_k1_block7": cfg10_config(2, 8, "2 s", k=1, flows=4, flow_segs=20),
    # the wheel's planes under the guards: 40 PHOLD hosts, 4 wheel slots
    # in blocks of 2, a bucketed queue
    "wheel": {**DRILL, "experimental": {**DRILL["experimental"], "timer_wheel": 4,
                                        "timer_wheel_block": 2, "event_queue_capacity": 16,
                                        "event_queue_block": 4},
              "hosts": {"node": {**DRILL["hosts"]["node"], "count": 40}}},
}


def jax_scribble(mode):
    """The JAX package's drill hook: queue slot (0, 0)'s time to 0 at
    round 16, once or on every attempt."""
    fired = []

    def hook(st, attempt):
        if int(st.stats.rounds) < 16 or (mode == "once" and (attempt or fired)):
            return st
        fired.append(1)
        t = np.asarray(jax.device_get(st.queue.t)).copy()
        t[0, 0] = 0
        return st._replace(queue=st.queue._replace(t=jnp.asarray(t)))

    return hook


def results(report: dict) -> dict:
    return {k: v for k, v in report.items() if k not in _NOT_RESULTS}


@pytest.fixture(autouse=True)
def _one_thread():
    """H <= 64: PyTorch's intra-op threads only slow these tensors down."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_runs():
    """(report, final sentinel lanes) of every JAX reference, computed once."""
    out = {}
    for name, cfg in [*RUNS.items(), ("clean", DRILL), ("once", DRILL), ("always", DRILL)]:
        sim = JaxSimulation(JaxConfigOptions.from_dict(cfg), world=1)
        if name in ("once", "always"):
            sim._integrity_test_scribble = jax_scribble(name)
        rep = sim.run(progress=False)
        st = jax.tree.map(np.array, jax.device_get(sim.state))
        out[name] = (rep, {k: v for k, v in to_numpy(st).items() if k in _LANES})
    return out


def port_run(cfg, hook=None):
    sim = Simulation(ConfigOptions.from_dict(cfg), device="cpu")
    sim._integrity_test_scribble = hook
    rep = sim.run(progress=False)
    return rep, {k: v for k, v in to_numpy(sim.state).items() if k in _LANES}


def assert_lanes_equal(got, want):
    assert got.keys() == want.keys() == set(_LANES)
    assert [k for k in got if not np.array_equal(got[k], want[k])] == []


@pytest.mark.parametrize("name", list(RUNS))
def test_config10_small_matches_jax(name, jax_runs):
    rep, lanes = port_run(RUNS[name])
    jrep, jlanes = jax_runs[name]
    assert results(rep) == results(jrep)
    assert_lanes_equal(lanes, jlanes)
    assert rep["integrity"]["determinism_digest2"] and lanes["stats.iv_round"][0] == -1
    if name == "wheel":
        assert rep["wheel"]["occupancy_hwm"] > 0


def test_transient_scribble_is_replayed_and_survived(jax_runs):
    rep, lanes = port_run(DRILL, scribble_hook("once"))
    jrep, jlanes = jax_runs["once"]
    assert results(rep) == results(jrep)
    assert_lanes_equal(lanes, jlanes)
    assert (rep["integrity"]["transients"], rep["integrity"]["replays"]) == (1, 1)
    clean = jax_runs["clean"][0]
    assert rep["determinism_digest"] == clean["determinism_digest"]
    assert rep["integrity"]["determinism_digest2"] == clean["integrity"]["determinism_digest2"]


def test_persistent_scribble_aborts_like_jax(jax_runs):
    rep, lanes = port_run(DRILL, scribble_hook("always"))
    jrep, jlanes = jax_runs["always"]
    assert results(rep) == results(jrep)
    assert_lanes_equal(lanes, jlanes)
    det = rep["integrity"]["deterministic"]
    assert rep["integrity_aborted"] and rep["aborted"] and rep["rounds"] == 16
    assert "time_monotonic" in det["detail"] and "round 16" in det["detail"]


def _set(field, idx, fn):
    """A hook changing one stats or state lane at round 8, on every attempt."""
    def hook(st, attempt):
        if int(st.stats.rounds) < 8:
            return st
        obj = st.stats if hasattr(st.stats, field) else st
        lane = getattr(obj, field) if hasattr(obj, field) else getattr(st.queue, field)
        lane[idx] = fn(lane[idx])
        return st
    return hook


@pytest.mark.parametrize("name, hook, bit, block", [
    ("counter", _set("events", 3, lambda v: -7), "counter_monotonic", 8),
    ("outbox", _set("sent_round", 0, lambda v: 99), "outbox_budget", 8),
    ("fill", _set("bfill", (0, 0), lambda v: v + 1), "queue_fill_cache", 8),
    # on the flat queue (a bucketed one's caches would not see the slot)
    ("time", scribble_hook("always", 8), "time_monotonic", 0),
    # a host that has executed nothing must hold both digests' offsets
    ("digest", _set("events", 2, lambda v: 0), "dual_digest_virgin", 8),
])
def test_each_guard_trips(name, hook, bit, block):
    """Each guard trips on its own crafted violation at round 8, and the
    run reports the last good state (the pre-chunk snapshot)."""
    cfg = {**DRILL, "experimental": {**DRILL["experimental"], "event_queue_block": block}}
    rep, lanes = port_run(cfg, hook)
    det = rep["integrity"]["deterministic"]["detail"]
    assert rep["integrity_aborted"] and bit in det and "round 8" in det, det
    assert rep["rounds"] == 8 and lanes["stats.iv_mask"][0] == 0


def test_helpers_match_jax():
    for mask in (0, 1, 0b101101, 1 << 7 | 3):
        assert integrity.mask_names(mask) == jax_integrity.mask_names(mask)
    sig = ((0, 16, 0b1001),)
    assert integrity.describe_signature(sig) == jax_integrity.describe_signature(sig)
    for args in ((1, 2, 1, 2), (1, 2, 3, 2), (1, 2, 1, 3), (1, None, 1, 2), (1, None, 2, None)):
        assert integrity.classify_digest_pair(*args) == jax_integrity.classify_digest_pair(*args)
    assert (integrity.DIGEST2_OFFSET, integrity.DIGEST2_PRIME, integrity.IV_NAMES) == \
        (jax_integrity.DIGEST2_OFFSET, jax_integrity.DIGEST2_PRIME, jax_integrity.IV_NAMES)
