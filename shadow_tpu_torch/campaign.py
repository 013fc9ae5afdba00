"""Campaign driver: R replicas in one folded round loop, with the digest
ledger and divergence bisection (port of the JAX repo's tools/campaign.py).

A `campaign:` config block declares sweep axes — seed lists or ranges,
fault-schedule lists, config-override lists — and this driver:

  1. expands their cross product into replica configs (at the config-dict
     level, so an override can reach anything in the YAML that changes
     array values only; a delta that changes an EngineConfig static or a
     routing table is refused at build);
  2. builds each replica exactly as its solo run would (`Simulation`),
     reconciles the fault statics, folds the states and params
     (core/ensemble.py) and advances ALL replicas one chunk per dispatch,
     each kernel launching once per step for all of them — under the run
     supervisor when configured (snapshots, on-disk ensemble checkpoints,
     `--resume`);
  3. writes the per-replica digest ledger (the JAX package's keys): final
     per-replica counters and digests and per-chunk xor digest signatures
     (K32), plus the port's `device`, `host_syncs` and `kernel_launches`;
  4. checks every `expect_identical` pair on the full per-host digest
     arrays and, on a divergence, bisects over chunk boundaries to the
     first divergent chunk.

Usage:
    python -m shadow_tpu_torch.campaign CONFIG.yaml [-o LEDGER.json] [--resume]
                                                    [--device cpu]

It runs on the CUDA card unless `--device cpu` asks for the CPU; without a
card and without that flag it fails. Refused under a campaign, with the JAX
package's messages: world > 1, pressure escalate or abort, merge gears and
the integrity sentinel; and, naming the knob, the observatories (the
per-replica round tracer) and the fluid plane. Hybrid processes, the
cpu-reference scheduler and pcap capture, which the JAX driver refuses
here too, never reach it: the port's config parse refuses them first.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from shadow_tpu_torch.config.options import ConfigError, ConfigOptions


@dataclasses.dataclass(frozen=True)
class ReplicaSpec:
    """One expanded replica: its axis coordinates and config deltas."""

    index: int
    label: str
    seed: int
    faults: dict | None  # raw faults block; None = the base config's
    overrides: dict  # dotted config-dict paths -> values

    def meta(self) -> dict:
        return {
            "index": self.index,
            "label": self.label,
            "seed": self.seed,
            "faults": self.faults,
            "overrides": {k: str(v) for k, v in self.overrides.items()},
        }


def expand_replicas(cfg: ConfigOptions) -> list[ReplicaSpec]:
    """Cross product of the campaign axes in (seed, fault_schedule,
    override) nesting order — the index formula documented on
    CampaignOptions."""
    camp = cfg.campaign
    if not camp.active:
        raise ConfigError(
            "campaign: no sweep axes declared (seeds / fault_schedules / "
            "overrides)"
        )
    seeds = camp.seeds or [cfg.general.seed]
    scheds: list = camp.fault_schedules or [None]
    ovs = camp.overrides or [{}]
    specs: list[ReplicaSpec] = []
    for seed in seeds:
        for fi, sched in enumerate(scheds):
            for oi, ov in enumerate(ovs):
                parts = [f"seed={seed}"]
                if camp.fault_schedules:
                    parts.append(f"faults={fi}")
                if camp.overrides:
                    parts.append(f"ov={oi}")
                specs.append(ReplicaSpec(index=len(specs), label=",".join(parts),
                                         seed=int(seed), faults=sched, overrides=dict(ov)))
    return specs


def _apply_dict_override(d: dict, dotted: str, value):
    """Set a dotted path inside the raw config mapping; integer segments
    index into lists (e.g. hosts.node.processes.0.model_args.mean_delay)."""
    parts = dotted.split(".")
    cur = d
    for p in parts[:-1]:
        if isinstance(cur, list):
            cur = cur[int(p)]
        else:
            if p not in cur or cur[p] is None:
                cur[p] = {}
            cur = cur[p]
    leaf = parts[-1]
    if isinstance(cur, list):
        cur[int(leaf)] = value
    else:
        cur[leaf] = value


def replica_config_dict(base: dict, spec: ReplicaSpec) -> dict:
    """One replica's raw config mapping: base + seed + fault schedule +
    overrides. The per-replica faults block keeps only the injection
    fields: the supervisor is the campaign's, read from the base block."""
    d = copy.deepcopy(base)
    d.setdefault("general", {})["seed"] = spec.seed
    if spec.faults is not None:
        d["faults"] = copy.deepcopy(spec.faults)
    d.pop("campaign", None)  # replicas are solo configs
    for k, v in spec.overrides.items():
        try:
            _apply_dict_override(d, k, v)
        except (KeyError, IndexError, ValueError, TypeError) as e:
            raise ConfigError(
                f"campaign override {k!r} does not resolve in the config: {e}"
            ) from e
    return d


def _refuse(cfg: ConfigOptions) -> None:
    """The campaign's build-time refusals (the JAX package's, plus the
    planes the port's fold does not run, each naming its knob)."""
    from shadow_tpu_torch.core.mesh import resolve_world

    if cfg.general.parallelism > 1 or (
            cfg.general.parallelism == 0 and torch.cuda.is_available()
            and resolve_world(0, torch.device("cuda")) > 1):
        raise ConfigError(
            "campaign: the ensemble plane runs world=1 this round "
            "(a replica axis over a device mesh is a 2-D mesh "
            "program); set general.parallelism to 1 or shard the "
            "campaign across processes"
        )
    if cfg.pressure.active:
        raise ConfigError(
            "campaign: pressure escalate/abort are not supported with "
            "the ensemble plane this round (a capacity migration "
            "would have to re-seat every replica's slab mid-campaign);"
            " keep pressure: drop and size replica capacities up front"
        )
    if cfg.experimental.merge_gears:
        raise ConfigError(
            "campaign: experimental.merge_gears is not supported with "
            "the ensemble plane this round (gear replay would need "
            "per-replica shed tracking across the vmap)"
        )
    if cfg.integrity.enabled:
        raise ConfigError(
            "campaign: the integrity sentinel is not supported with "
            "the ensemble plane this round (the quarantine-and-replay "
            "classifier would need per-replica violation signatures "
            "across the vmap); disable the integrity block or run the "
            "scenarios solo"
        )
    obs = cfg.observability
    for knob, on in (("trace", obs.trace), ("network", obs.network), ("memory", obs.memory),
                     ("runtime", obs.runtime), ("profile_dir", obs.profile_dir)):
        if on:
            raise ConfigError(
                f"campaign: observability.{knob} is not supported with the ensemble plane in "
                f"the PyTorch port yet (the per-replica observers need the round trace ring "
                f"and its peers per replica); drop the observability block or run the "
                f"scenarios solo")
    if cfg.fluid.active:
        raise ConfigError(
            "campaign: the fluid block is not supported with the ensemble plane in the "
            "PyTorch port yet (its per-link state has no replica axis); drop the fluid block "
            "or run the scenarios solo")


class Campaign:
    """Built campaign: the folded ensemble plus what the run loop and the
    ledger need. Build via `build_campaign(config_dict)`."""

    def __init__(self, base_cfg: ConfigOptions, base_dict: dict,
                 capacity_bytes: int | None = None, device=None):
        from shadow_tpu_torch import resolve_device
        from shadow_tpu_torch.core.ensemble import build_ensemble
        from shadow_tpu_torch.obs.memory import device_capacity_bytes, tree_bytes
        from shadow_tpu_torch.sim import Simulation

        self.cfg = base_cfg
        self.device = resolve_device(device)
        _refuse(base_cfg)
        self.specs = expand_replicas(base_cfg)
        sims = []
        for spec in self.specs:
            rcfg = ConfigOptions.from_dict(replica_config_dict(base_dict, spec))
            sims.append(Simulation(rcfg, device=self.device))
        self.num_real = sims[0]._num_real
        self.model = sims[0].model
        self.rounds_per_chunk = sims[0].engine_cfg.effective_rounds_per_chunk
        # the replica-memory guard: R x the per-replica state bytes plus
        # the params' bytes against the device's capacity (`capacity_bytes`
        # overrides the probe; None and no measurable capacity: no check)
        per_replica = tree_bytes(sims[0].state)
        shared = tree_bytes(sims[0].params)
        predicted = per_replica * len(self.specs) + shared
        if capacity_bytes is None:
            capacity_bytes = device_capacity_bytes(self.device)
        self.predicted_bytes = predicted
        self.per_replica_bytes = per_replica
        if capacity_bytes is not None and predicted > capacity_bytes:
            raise ConfigError(
                f"campaign: {len(self.specs)} replicas need a predicted "
                f"{predicted} bytes of device memory ({len(self.specs)} x "
                f"{per_replica} per-replica state + {shared} shared "
                f"params), over the device capacity {capacity_bytes} "
                f"bytes — shard the campaign across processes or shrink "
                f"the replica axes (static model: shadow_tpu_torch/obs/memory.py)"
            )
        self.engine, self.state = build_ensemble(
            self.model, [(s.engine.cfg, s.state, s.params) for s in sims], self.device,
            labels=[s.label for s in self.specs])
        self.num_replicas = len(self.specs)
        # the per-replica simulations are scaffolding: their engines never run
        del sims

    def fingerprint(self) -> str:
        from shadow_tpu_torch.core.checkpoint import ensemble_fingerprint

        return ensemble_fingerprint(self.engine.engine.cfg, self.state, self.engine._params,
                                    [s.meta() for s in self.specs])


def build_campaign(config_dict: dict, capacity_bytes: int | None = None,
                   device=None) -> Campaign:
    return Campaign(ConfigOptions.from_dict(config_dict), config_dict,
                    capacity_bytes=capacity_bytes, device=device)


def run_campaign(config_dict: dict, *, log=sys.stderr, ledger_path: str | None = None,
                 resume: bool = False, wall_budget_s: float | None = None,
                 device=None) -> dict:
    """Build and run a campaign; returns (and writes) the digest ledger.
    `device` is the CUDA card unless "cpu" is asked for."""
    from shadow_tpu_torch.core.checkpoint import (
        load_ensemble_checkpoint,
        save_ensemble_checkpoint,
        snapshot_state,
    )
    from shadow_tpu_torch.core.ensemble import (
        bisect_divergence,
        pair_digests_equal,
        replica_ledger,
    )
    from shadow_tpu_torch.core.supervisor import ChunkSupervisor, SupervisorAbort
    from shadow_tpu_torch.ops.ensemble import replica_fold
    from shadow_tpu_torch.sim import KERNELS, heartbeat_line

    camp_t0 = time.monotonic()
    c = build_campaign(config_dict, device=device)
    cfg, camp = c.cfg, c.cfg.campaign
    state = c.state
    ens = c.engine
    r_count = c.num_replicas
    print(
        f"[campaign] {r_count} replicas x {cfg.general.stop_time / 1e9:.3f} "
        f"sim-s, rounds_per_chunk={c.rounds_per_chunk}",
        file=log,
    )

    # the supervisor (campaign-level, from the base faults block): snapshots
    # copy the folded state whole; the on-disk checkpoint is guarded by the
    # campaign's fingerprint
    sup = None
    ckpt_path = None
    fingerprint = None
    so = cfg.faults.supervisor
    if so.enabled:
        fingerprint = c.fingerprint()
        ckpt_path = so.checkpoint_file
        if ckpt_path is not None:
            if not os.path.isabs(ckpt_path):
                ckpt_path = os.path.join(cfg.general.data_directory, ckpt_path)
            os.makedirs(os.path.dirname(ckpt_path) or ".", exist_ok=True)
        sup = ChunkSupervisor(
            snapshot_every_chunks=so.snapshot_every_chunks,
            max_retries=so.max_retries,
            backoff_base_s=so.backoff_base_ms / 1000.0,
            checkpoint_path=ckpt_path,
            save_fn=((lambda path, snap: save_ensemble_checkpoint(path, snap, fingerprint))
                     if ckpt_path else None),
            log=log,
        )
    if resume:
        real = None
        if ckpt_path:
            real = ckpt_path if ckpt_path.endswith(".npz") else ckpt_path + ".npz"
        if real is None or not os.path.exists(real):
            raise ConfigError(
                "campaign --resume: no ensemble checkpoint found (set "
                "faults.supervisor.checkpoint_file and run once first)"
            )
        state = load_ensemble_checkpoint(real, state, fingerprint or c.fingerprint())
        print(f"[campaign] resumed from {real}", file=log)
    if sup is not None:
        sup.note_state(state)

    # the pre-run snapshot for bisection (chunk 0 of the replay search)
    snap0 = snapshot_state(state) if camp.bisect and camp.expect_identical else None

    hb_ns = cfg.general.heartbeat_interval
    next_hb = hb_ns or 0
    chunk_sigs: list[list[str]] = []
    chunks = 0
    aborted = truncated = False
    syncs = 0  # the driver's own device-to-host reads
    launches0 = {k: v.launches for k, v in KERNELS.items()}
    syncs0 = ens.host_syncs
    if c.device.type == "cuda":
        torch.cuda.synchronize(c.device)
    t0 = time.monotonic()
    while not state.done.all():
        if sup is not None:
            try:
                state = sup.run_chunk(state, ens.run_chunk)
            except SupervisorAbort as e:
                print(f"[campaign] aborting run: {e}", file=log)
                good = sup.abort_export_state()
                if good is not None:
                    state = good
                aborted = True
                break
        else:
            state = ens.run_chunk(state)
        # the chunk index from the state (a supervisor recovery may rewind),
        # with the per-chunk xor signatures (K32), in one read
        sig = replica_fold(state.stats.digest, [], r_count, c.num_real)[:, 0]
        got = torch.stack([sig, state.stats.rounds]).cpu().numpy()
        syncs += 1
        chunks = -(-int(got[1].max()) // c.rounds_per_chunk)
        sigs = [f"{int(s):016x}" for s in got[0].view(np.uint64)]
        if chunks > len(chunk_sigs):
            chunk_sigs.append(sigs)
        elif chunks:
            chunk_sigs[chunks - 1] = sigs
        if hb_ns:
            active = state.now[~state.done]
            now_ns = int(active.min() if active.size else state.now.max())
            if now_ns >= next_hb:
                s = state.stats
                vals = torch.stack([s.events.sum(), s.microsteps.sum(), s.rounds.sum(),
                                    s.q_occ_hwm.max(), s.ici_bytes.sum(),
                                    *((s.faults_dropped.sum(), s.faults_delayed.sum())
                                      if s.faults_dropped is not None else ())]).tolist()
                syncs += 1
                print(heartbeat_line(
                    now_ns, time.monotonic() - t0, vals[0], vals[1], vals[2], vals[3],
                    ens.host_syncs - syncs0 + syncs,
                    fault=(vals[5], vals[6]) if len(vals) > 5 else None, ici=vals[4],
                    rep=(int(state.done.sum()), r_count)), file=log)
                next_hb = (now_ns // hb_ns + 1) * hb_ns
        if wall_budget_s is not None and time.monotonic() - t0 > wall_budget_s:
            print("[campaign] wall budget exhausted, stopping", file=log)
            truncated = True
            break
    if c.device.type == "cuda":
        torch.cuda.synchronize(c.device)
    wall = time.monotonic() - t0
    launches = {k: v.launches - launches0[k] for k, v in KERNELS.items()}
    host_syncs = ens.host_syncs - syncs0 + syncs + (sup.syncs if sup is not None else 0)

    # ---- ledger: the chunk index from the exported state (an abort adopts
    # a snapshot behind the loop's last dispatch)
    chunks = -(-int(state.stats.rounds.max()) // c.rounds_per_chunk)
    chunk_sigs = chunk_sigs[:chunks]
    rows = replica_ledger(state, c.num_real, labels=[s.label for s in c.specs])
    identical, inconclusive, divergences = [], [], []
    if not aborted:
        for pair in camp.expect_identical:
            pair_t = (int(pair[0]), int(pair[1]))
            if pair_digests_equal(state, pair_t, c.num_real):
                # equal on a budget-truncated prefix proves nothing
                (inconclusive if truncated else identical).append(list(pair_t))
                continue
            entry = {"pair": list(pair_t), "first_divergent_chunk": None}
            if camp.bisect and snap0 is not None:
                if not pair_digests_equal(snap0, pair_t, c.num_real):
                    entry["divergent_at_start"] = True
                else:
                    entry["first_divergent_chunk"] = bisect_divergence(
                        ens.run_chunk, snap0, pair_t, hi=chunks, num_real=c.num_real, log=log)
                    if resume:
                        entry["relative_to_resume"] = True
            divergences.append(entry)
    ledger = {
        "campaign": {
            "replicas": r_count,
            "labels": [s.label for s in c.specs],
            "seeds": [s.seed for s in c.specs],
            "chunks": chunks,
            "rounds_per_chunk": c.rounds_per_chunk,
            "num_hosts": c.num_real,
            "wall_seconds": round(wall, 4),
            "build_seconds": round(t0 - camp_t0, 4),
            **({"aborted": True} if aborted else {}),
            **({"truncated": True} if truncated else {}),
            **({"supervisor": sup.report()} if sup is not None else {}),
            "device": str(c.device),
            "host_syncs": host_syncs,
            "kernel_launches": launches,
        },
        "replicas": rows,
        "chunk_digest_sigs": chunk_sigs,
        "expect_identical": [list(p) for p in camp.expect_identical],
        "identical": identical,
        **({"inconclusive": inconclusive} if inconclusive else {}),
        "divergences": divergences,
    }
    path = ledger_path
    if path is None and camp.ledger_file:
        os.makedirs(cfg.general.data_directory, exist_ok=True)
        path = os.path.join(cfg.general.data_directory, camp.ledger_file)
    if path:
        with open(path, "w") as f:
            json.dump(ledger, f, indent=2)
        print(f"[campaign] ledger written: {path}", file=log)
    return ledger


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="shadow_tpu_torch.campaign",
        description="run a campaign: block's replicas as one folded round loop")
    p.add_argument("config", help="YAML config with a campaign: block")
    p.add_argument("-o", "--output", help="ledger path (default: "
                   "data_directory/campaign.ledger_file)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the supervisor's ensemble checkpoint")
    p.add_argument("--wall-budget", type=float, default=None,
                   help="stop after this many wall seconds (partial ledger)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    import yaml

    try:
        with open(args.config) as f:
            config_dict = yaml.safe_load(f)
        if not isinstance(config_dict, dict):
            raise ConfigError("config must be a YAML mapping")
        ledger = run_campaign(config_dict, ledger_path=args.output, resume=args.resume,
                              wall_budget_s=args.wall_budget, device=args.device)
    except (ConfigError, OSError, yaml.YAMLError) as e:
        print(f"config error: {e}", file=sys.stderr)
        return 2
    except RuntimeError as e:  # no CUDA device and no --device cpu
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(json.dumps({
        "replicas": ledger["campaign"]["replicas"],
        "chunks": ledger["campaign"]["chunks"],
        "wall_seconds": ledger["campaign"]["wall_seconds"],
        "device": ledger["campaign"]["device"],
        "digests": [r["digest"] for r in ledger["replicas"]],
        "identical": ledger["identical"],
        "divergences": ledger["divergences"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
