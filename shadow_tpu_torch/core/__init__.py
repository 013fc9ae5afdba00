"""PDES core: the single-device round loop, its robustness planes and the
state carried across from the JAX package.

The engine's names are resolved on first use, so that the plane modules
(`core.faults`, `core.integrity`) can be imported by the kernels' modules
without importing the engine."""

_ENGINE_NAMES = ("Engine", "EngineConfig", "EngineParams", "Outbox", "SimState", "Stats")


def __getattr__(name):
    if name in _ENGINE_NAMES:
        from shadow_tpu_torch.core import engine

        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = list(_ENGINE_NAMES)
