"""JAX's one pool over a data mesh, in a process of its own: the reference
of tests/test_torch_data_mesh.py.

JAX fixes its device count when it first initialises, once a process, so a
test worker that has already used JAX cannot make the two CPU devices that
``make_data_mesh(2)`` needs.  This script runs with
``XLA_FLAGS=--xla_force_host_platform_device_count=2``:

    python tests/_jax_data_mesh.py CASES OUT

CASES is a pickle of {name: (weights pickle, arch, ecfg_kw, engine_kw,
plan)} (as tests/_dist_ranks.py's ``data_mesh_serve`` takes them); OUT
receives {name: ``serve_pool_plan``'s record} of JAX's
``BatchedSpeculativeEngine(..., mesh=make_data_mesh(2))`` on each case, the
float32 smoke ``arch`` and its draft with the pickled parameters.
"""
import os
import pickle
import sys


def main(cases_path: str, out_path: str) -> None:
    import jax
    import jax.numpy as jnp

    from _dist_ranks import serve_pool_plan
    from repro.configs import get_smoke
    from repro.launch.mesh import make_data_mesh
    from repro.launch.serve import make_draft_cfg
    from repro.serving import batch_engine as jbe
    from repro.serving import engine as jeng

    if jax.device_count() < 2:
        raise RuntimeError(f"{jax.device_count()} JAX device(s): run with "
                           "XLA_FLAGS=--xla_force_host_platform_device_count=2")
    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    out = {}
    for name, (weights, arch, ecfg_kw, engine_kw, plan) in cases.items():
        with open(weights, "rb") as f:
            np_tp, np_dp = pickle.load(f)
        cfg = get_smoke(arch).replace(dtype="float32")
        eng = jbe.BatchedSpeculativeEngine(cfg, jax.tree.map(jnp.asarray, np_tp), make_draft_cfg(cfg),
                                           jax.tree.map(jnp.asarray, np_dp), jeng.EngineConfig(**ecfg_kw),
                                           mesh=make_data_mesh(2), **engine_kw)
        out[name] = serve_pool_plan(eng, plan)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [here, os.path.join(here, "..", "src")]
    main(*sys.argv[1:])
