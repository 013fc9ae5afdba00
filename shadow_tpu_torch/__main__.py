"""CLI: `python -m shadow_tpu_torch [OPTIONS] <config.yaml | ->`.

The JAX package's interface: every `--section.key=value` flag overrides the
matching config field, CLI winning. Runs on the CUDA device; `--device cpu`
runs the plain PyTorch path on the CPU. Writes sim-stats.json,
processed-config.yaml, hosts/<name>/host-stats.json and, with
`observability.trace`, trace.json and metrics.prom into the data
directory. Exit code 2 on a config
error, including every knob the port does not support yet.

With `general.parallelism: N` (N > 1; 0 = every visible card) the command
launches N ranks itself (core/mesh.py): NCCL ranks on cuda:0..N-1, or with
`--device cpu` N gloo processes; rank 0 writes the outputs.

A config with a managed process (`path:` naming a registered coroutine
program) runs the co-simulation bridge (cosim.py): the CPU host plane over
the device network, writing each process's stdout, stderr and, with
`experimental.strace_logging_mode`, strace under hosts/<name>/.

A config with a `campaign:` block (a sweep of replicas) exits 2 with a
pointer to `python -m shadow_tpu_torch.campaign CONFIG.yaml`, which runs
it; no replica runs alone here.
"""

from __future__ import annotations

import argparse
import json
import sys

import yaml

from shadow_tpu_torch import __version__
from shadow_tpu_torch.config.options import ConfigError, load_config, merge_cli_overrides


def _split_overrides(extra: list[str]) -> dict[str, str]:
    out: dict[str, str] = {}
    i = 0
    while i < len(extra):
        a = extra[i]
        if not a.startswith("--"):
            raise ConfigError(f"unexpected argument {a!r}")
        body = a[2:]
        if "=" in body:
            k, v = body.split("=", 1)
        else:
            if i + 1 >= len(extra):
                raise ConfigError(f"flag {a!r} needs a value")
            k, v = body, extra[i + 1]
            i += 1
        out[k.replace("-", "_")] = v
        i += 1
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="shadow_tpu_torch",
        description="conservative-PDES network simulator, PyTorch/CUDA port",
        epilog="Any config field can be overridden with --section.key=value, "
               "e.g. --general.stop_time='10 s'",
    )
    p.add_argument("config", help="YAML simulation config ('-' = stdin)")
    p.add_argument("--version", action="version", version=__version__)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--progress", action="store_true", help="print a progress line")
    p.add_argument("--print-stats", action="store_true",
                   help="print the sim-stats JSON to stdout after the run")
    args, extra = p.parse_known_args(argv)
    try:
        cfg = load_config(args.config)
        overrides = _split_overrides(extra)
        if overrides:
            cfg = merge_cli_overrides(cfg, overrides)
        if args.progress:
            cfg.general.progress = True
        from shadow_tpu_torch import resolve_device
        from shadow_tpu_torch.core.mesh import resolve_world
        from shadow_tpu_torch.config.options import config_is_cosim
        from shadow_tpu_torch.sim import build_simulation, run_mesh

        dev = resolve_device(args.device)
        world = 1 if config_is_cosim(cfg) else resolve_world(cfg.general.parallelism, dev)
        cfg.check_world(world)
        sim = build_simulation(cfg, device=dev) if world == 1 else None
    except (ConfigError, OSError, yaml.YAMLError) as e:
        print(f"config error: {e}", file=sys.stderr)
        return 2
    except RuntimeError as e:  # no CUDA device and no --device cpu
        print(f"error: {e}", file=sys.stderr)
        return 1
    if sim is None:
        data_dir = cfg.general.data_directory
        report = run_mesh(cfg, device=dev, data_dir=data_dir)
    else:
        report = sim.run()
        data_dir = sim.write_outputs(report=report)
    if args.print_stats:
        json.dump(report, sys.stdout, indent=2)
        print()
    print(
        f"done: simulated {report['simulated_seconds']:.3f}s in "
        f"{report['wall_seconds']:.2f}s ({report['sim_wall_ratio']:.2f}x) on "
        f"{report['device']}, {report['events_processed']} events, "
        f"digest {report['determinism_digest']}; outputs in {data_dir}/",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
