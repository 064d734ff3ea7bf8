"""The rank side of tests/test_torch_distributed.py,
tests/test_torch_rank_shards.py and tests/test_torch_data_mesh.py.

``spawn`` (or ``Ranks``, which lets the caller work while the ranks run)
runs a function of this module in ``world`` spawned processes,
joined in one ``gloo`` process group through a file; each process imports
only torch and the port (neither JAX nor pytest), and what rank 0 returns
comes back to the caller.  A rank that raises fails the call with its
traceback; a rank that hangs fails it after ``timeout`` seconds, and every
process is killed.
"""
from __future__ import annotations

import multiprocessing
import queue
import traceback

import numpy as np
import torch
import torch.distributed as dist


def _main(fn_name: str, rank: int, world: int, init_file: str, args: tuple, out) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
        try:
            result = globals()[fn_name](rank, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result if rank == 0 else None))
    except BaseException:  # reported to the parent, which fails the test
        out.put((rank, False, traceback.format_exc()))


class Ranks:
    """``world`` spawned processes running ``fn_name(rank, *args)``; the
    caller may work meanwhile and collects with ``result``."""

    def __init__(self, fn_name: str, world: int, init_file: str, args: tuple = ()):
        ctx = multiprocessing.get_context("spawn")
        self.world, self.out = world, ctx.Queue()
        self.procs = [ctx.Process(target=_main, args=(fn_name, r, world, init_file, args, self.out), daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def result(self, timeout: float = 200.0):
        """Rank 0's return value; raises if a rank failed, or if the ranks
        did not all finish within ``timeout`` seconds; every process is
        ended either way."""
        results = {}
        try:
            for _ in range(self.world):
                rank, ok, payload = self.out.get(timeout=timeout)
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                results[rank] = payload
        except queue.Empty:
            raise TimeoutError(f"{self.world - len(results)} of {self.world} ranks did not finish within "
                               f"{timeout} s") from None
        finally:
            for p in self.procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        return results[0]


def spawn(fn_name: str, world: int, init_file: str, args: tuple = (), timeout: float = 200.0):
    """Rank 0's return value of ``fn_name(rank, *args)`` run on ``world``
    ranks."""
    return Ranks(fn_name, world, init_file, args).result(timeout)


def _mesh(shape: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def train_steps(rank: int, shape: tuple, cases: dict, opt_kw: dict) -> dict:
    """Per arch of ``cases`` ({arch: (numpy params, [numpy batch, ...])}):
    the float32 smoke config's parameters placed over a ``shape`` mesh, one
    ``make_sharded_train_step`` step a batch; returns {arch: (losses,
    {path: gathered numpy leaf})}."""
    from repro_torch import bridge
    from repro_torch.configs import get_smoke
    from repro_torch.launch.sharding import gather
    from repro_torch.launch.train import make_sharded_train_step, place_params
    from repro_torch.training.loop import to_device
    from repro_torch.training.optim import AdamW

    mesh = _mesh(shape)
    opt = AdamW(**opt_kw)
    out = {}
    for arch, (np_params, batches) in cases.items():
        cfg = get_smoke(arch).replace(dtype="float32")
        params = place_params(mesh, cfg, bridge.params_from_jax(np_params, device="cpu"))
        state = opt.init(params)
        step = make_sharded_train_step(cfg, opt, mesh)
        losses = []
        for b in batches:
            params, state, loss = step(params, state, to_device(b, "cpu"))
            losses.append(float(loss))
        out[arch] = (losses, _flat(gather(params)))
    return out


def _flat(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], f"{prefix}{key}/").items()}
    return {prefix[:-1]: tree.detach().numpy()}


def pins_and_pool(rank: int) -> dict:
    """On a (2, 2) mesh: the placements ``pin`` and ``pin_moe_buffer`` give
    (and what they leave alone); then a dense ring pool placed by
    ``pool_shardings`` over a 2-rank data mesh, its local rows and the pool
    gathered back."""
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.launch.sharding import gather, pool_shardings
    from repro_torch.models import act_sharding
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.transformer import init_cache

    mesh = _mesh((2, 2))
    rep = (Replicate(), Replicate())
    x = distribute_tensor(torch.arange(4 * 3 * 8, dtype=torch.float32).reshape(4, 3, 8), mesh, rep)
    odd = distribute_tensor(torch.zeros(3, 8), mesh, rep)
    buf = distribute_tensor(torch.zeros(4, 6, 8), mesh, rep)
    res = {"unpinned": act_sharding.pin(x).placements}
    with act_sharding.activation_sharding(mesh, ("data",)):
        pinned = act_sharding.pin(x)
        res.update(pinned=pinned.placements, pinned_local=tuple(pinned.to_local().shape),
                   pinned_equal=bool(torch.equal(pinned.full_tensor(), x.full_tensor())),
                   odd=act_sharding.pin(odd).placements, plain=act_sharding.pin(torch.zeros(4, 3)).shape,
                   moe=act_sharding.pin_moe_buffer(buf).placements,
                   moe_local=tuple(act_sharding.pin_moe_buffer(buf).to_local().shape))
    res["cleared"] = act_sharding.pin(x).placements

    data = make_data_mesh(2, device_type="cpu")
    cfg = ModelConfig(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64, dtype="float32")
    cache = init_cache(cfg, 4, 16, "cpu", per_stream=True)
    gen = torch.Generator().manual_seed(0)
    cache["attn"]["k"].normal_(generator=gen)
    cache["attn"]["pos"].random_(0, 16, generator=gen)
    cache["attn"]["len"].random_(0, 16, generator=gen)
    if rank < 2:
        placed = pool_shardings(data, cache)
        k = placed["attn"]["k"]
        res.update(pool_dtensor=isinstance(k, DTensor), pool_local=tuple(k.to_local().shape),
                   pool_equal=all(np.array_equal(a, b) for a, b in
                                  zip(_flat(gather(placed)).values(), _flat(cache).values())))
    return res


class _Calls(list):
    restore = None


def _counted_gathers():
    """Count ``all_gather_object`` calls from here on (the engine's exchanges
    go through the module attribute); ``restore`` is the function it
    replaced."""
    calls = _Calls([0])
    calls.restore = gather_object = dist.all_gather_object

    def counted(*a, **kw):
        calls[0] += 1
        return gather_object(*a, **kw)

    dist.all_gather_object = counted
    return calls


def _rank_engine(weights: str, arch: str, ecfg_kw: dict, engine_kw: dict, target_device="cpu"):
    """A ShardedBatchedSpeculativeEngine over the whole group, one shard a
    rank, serving the float32 smoke ``arch`` and its draft with JAX's
    parameters (a pickle of the two numpy trees at ``weights``); the
    target's are moved to ``target_device``."""
    import pickle

    from repro_torch import bridge
    from repro_torch.configs import get_smoke
    from repro_torch.launch.serve import make_draft_cfg
    from repro_torch.serving.batch_engine import ShardedBatchedSpeculativeEngine
    from repro_torch.serving.engine import EngineConfig

    def to(tree):
        return {k: to(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(target_device)

    with open(weights, "rb") as f:
        np_tp, np_dp = pickle.load(f)
    cfg = get_smoke(arch).replace(dtype="float32")
    tp = to(bridge.params_from_jax(np_tp, device="cpu", dtype=torch.float32))
    dp = bridge.params_from_jax(np_dp, device="cpu", dtype=torch.float32)
    return ShardedBatchedSpeculativeEngine(cfg, tp, make_draft_cfg(cfg), dp, EngineConfig(**ecfg_kw),
                                           group=dist.group.WORLD, **engine_kw)


def serve_plan(eng, plan, busy=None) -> dict:
    """Serve ``plan`` ([("submit", [(prompt, max_new, seed), ...]) or
    ("steps", n)], then steps while ``busy()``, by default
    ``eng.has_work()``) through a sharded engine, the port's or JAX's:
    each request's shard at its submit, tokens and reason; the summed
    counters, the engine-level ones and the pool occupancy after every
    step; the steps taken."""
    rids, routing, occ, steps = [], [], [], 0

    def step():
        nonlocal steps
        eng.step()
        steps += 1
        occ.append(eng.pool_occupancy())

    for kind, arg in plan:
        if kind == "submit":
            for prompt, max_new, seed in arg:
                rids.append(eng.submit(list(prompt), max_new=max_new, seed=seed))
                routing.append(eng.shard_of(rids[-1]))
        else:
            for _ in range(arg):
                step()
    while (busy or eng.has_work)():
        step()
    outs = [(eng.finished[r]["tokens"], eng.finished[r]["reason"]) for r in rids]
    return {"outs": outs, "routing": routing, "counters": eng.counters, "engine_counters": dict(eng._counters),
            "occupancy": occ, "steps": steps}


def rank_shards_tree(rank: int, weights: str, arch: str, ecfg_kw: dict, engine_kw: dict, plan, launcher_argv):
    """One shard a rank on the tree strategy: ``plan`` through the rank
    engine (with every ``all_gather_object`` counted), then the refusals
    (a group whose size is not ``data_shards``; weights away from the
    rank's device), then a rank that raises in the middle of a run (rank
    1's verification), then the launcher's ``--distributed`` on
    ``launcher_argv`` with rank 0's output captured."""
    import contextlib
    import io

    from repro_torch.launch import serve

    calls = _counted_gathers()
    eng = _rank_engine(weights, arch, ecfg_kw, engine_kw)
    res = serve_plan(eng, plan)
    res.update(gathers=calls[0], exchanges=dict(eng.exchanges), local_counters=dict(eng.local.counters),
               n_shards=len(eng.shards), held=type(eng.shards[1 - rank]).__name__)
    refusals = {}
    for name, kw, device in (("group size", dict(engine_kw, data_shards=3), "cpu"),
                             ("weights' device", engine_kw, "meta")):
        try:
            _rank_engine(weights, arch, ecfg_kw, kw, target_device=device)
        except ValueError as e:
            refusals[name] = str(e)
    res["refusals"] = refusals
    failing = _rank_engine(weights, arch, ecfg_kw, engine_kw)
    if rank == 1:
        def broken(pending):
            raise RuntimeError("verification failed on purpose")
        failing.local.verify_step = broken
    try:
        serve_plan(failing, plan)
        res["failure"] = None
    except RuntimeError as e:
        res["failure"] = str(e)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(launcher_argv)
    res["launcher"] = out.getvalue()
    return res


def rank_shards_replay(rank: int, weights: str, arch: str, ecfg_kw: dict, engine_kw: dict, plan):
    """One shard a rank on the replay strategy: ``plan`` through the rank
    engine."""
    calls = _counted_gathers()
    eng = _rank_engine(weights, arch, ecfg_kw, engine_kw)
    res = serve_plan(eng, plan)
    res.update(gathers=calls[0], exchanges=dict(eng.exchanges), n_slots=eng.n_slots,
               local_slots=eng.local.n_slots)
    return res


# ------------------------------------------------- one pool over a data mesh ---


def serve_pool_plan(eng, plan, record=None) -> dict:
    """Serve ``plan`` (as ``serve_plan``) through one pool engine, the
    port's (any form) or JAX's: each request's tokens and reason; the
    counters; the pool occupancy after every step and, when given,
    ``record(eng)`` after every step; the steps taken."""
    rids, occ, recs, steps = [], [], [], 0

    def step():
        nonlocal steps
        eng.step()
        steps += 1
        occ.append(eng.pool_occupancy())
        if record is not None:
            recs.append(record(eng))

    for kind, arg in plan:
        if kind == "submit":
            for prompt, max_new, seed in arg:
                rids.append(eng.submit(list(prompt), max_new=max_new, seed=seed))
        else:
            for _ in range(arg):
                step()
    while eng.queue or eng.streams:
        step()
    outs = [(eng.finished[r]["tokens"], eng.finished[r]["reason"]) for r in rids]
    counters = {k: v for k, v in eng.counters.items() if k != "commit_ms"}
    return {"outs": outs, "counters": counters, "occupancy": occ, "records": recs, "steps": steps}


def held_rows(eng) -> dict:
    """{(pool, slot): {leaf: numpy}} of the port engine's live streams whose
    rows it holds: each cache leaf of the row, the attention K/V only at its
    live lanes (pos >= 0: what a mask can admit) and the block table left
    out (block ids are host state)."""
    from repro_torch.models.cache import gather_streams

    out = {}
    for name, pool in (("target", eng.tpool), ("draft", eng.dpool)):
        for s in eng.streams:
            if not pool.holds(s):
                continue
            row = gather_streams(pool.cache, [s - pool.lo])
            leaves = {}
            for key, val in row.items():
                if key == "attn":
                    live = val["pos"][0] >= 0
                    leaves.update({"pos": val["pos"].numpy(), "len": val["len"].numpy(),
                                   "k": val["k"][:, 0, live].float().numpy(),
                                   "v": val["v"][:, 0, live].float().numpy()})
                else:
                    leaves[key] = val.float().numpy()
            out[(name, s)] = leaves
    return out


def _mesh_engine(weights: str, arch: str, ecfg_kw: dict, engine_kw: dict, mesh):
    """A BatchedSpeculativeEngine over ``mesh`` (None: one process) serving
    the float32 smoke ``arch`` and its draft with JAX's parameters."""
    import pickle

    from repro_torch import bridge
    from repro_torch.configs import get_smoke
    from repro_torch.launch.serve import make_draft_cfg
    from repro_torch.serving.batch_engine import BatchedSpeculativeEngine
    from repro_torch.serving.engine import EngineConfig

    with open(weights, "rb") as f:
        np_tp, np_dp = pickle.load(f)
    cfg = get_smoke(arch).replace(dtype="float32")
    tp = bridge.params_from_jax(np_tp, device="cpu", dtype=torch.float32)
    dp = bridge.params_from_jax(np_dp, device="cpu", dtype=torch.float32)
    return BatchedSpeculativeEngine(cfg, tp, make_draft_cfg(cfg), dp, EngineConfig(**ecfg_kw), mesh=mesh,
                                    **engine_kw)


def data_mesh_serve(rank: int, cases: dict, failing: tuple) -> dict:
    """One pool over a 2-rank data mesh (gloo, the CPU).  For each case of
    ``cases`` ({name: (weights pickle, arch, ecfg_kw, engine_kw, plan)}):
    ``serve_pool_plan`` through the mesh-form engine with ``held_rows``
    after every step, every ``all_gather_object`` counted, and the
    engine's exchanges, idle passes and span totals.  Then the refusals, and the
    ``failing`` case (weights, arch, ecfg_kw, engine_kw, plan) twice with
    rank 1 failing: once in a pass whose readback is an exchange (the
    draft ingest), once outside every exchange (the target tree pass's
    dispatch).  Rank 0 returns every rank's results."""
    from repro_torch.launch.mesh import make_data_mesh

    mesh = make_data_mesh(2, device_type="cpu")
    res = {}
    for name, (weights, arch, ecfg_kw, engine_kw, plan) in cases.items():
        calls = _counted_gathers()
        eng = _mesh_engine(weights, arch, ecfg_kw, engine_kw, mesh)
        r = serve_pool_plan(eng, plan, held_rows)
        dist.all_gather_object = calls.restore
        r.update(gathers=calls[0], exchanges=dict(eng.exchanges), idle=dict(eng.idle_passes), spans=eng.span_totals,
                 rows=(eng.tpool.lo, eng.tpool.hi), local_len=int(eng.tpool.cache["attn"]["len"].shape[0])
                 if "attn" in eng.tpool.cache else int(eng.tpool.cache["len"].shape[0]))
        res[name] = r
    weights, arch, ecfg_kw, engine_kw, plan = failing
    refusals = {}
    for what, kw, m in (("n_slots", dict(engine_kw, n_slots=3), mesh),
                        ("model axis", engine_kw, _mesh_2d((1, 2), ("data", "model")))):
        try:
            _mesh_engine(weights, arch, ecfg_kw, kw, m)
        except (ValueError, NotImplementedError) as e:
            refusals[what] = f"{type(e).__name__}: {e}"
    res["refusals"] = refusals
    failures = {}
    for where in ("ingest", "tree"):
        eng = _mesh_engine(weights, arch, ecfg_kw, engine_kw, mesh)
        if rank == 1:
            def broken(*a, **kw):
                raise RuntimeError(f"the {where} pass failed on purpose")
            eng._steps[where] = broken
            if where == "tree":
                eng._steps["ragged"] = broken
        try:
            serve_pool_plan(eng, plan)
            failures[where] = None
        except RuntimeError as e:
            failures[where] = (str(e), dict(eng.exchanges))
    res["failures"] = failures
    got = [None, None]
    dist.all_gather_object(got, res)
    return got


def _mesh_2d(shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", shape, mesh_dim_names=names)
