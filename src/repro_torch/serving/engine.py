"""Speculative-decoding engine: delayed-tree drafting + tree-masked target
pass + lossless verification, with optional action selection.

The counterpart of ``SpeculativeEngine`` in src/repro/serving/engine.py,
with its two target-pass strategies:

  * "tree" (attention-based targets): one pass over the speculation block
    with the ancestor mask, then the accepted KVs are committed in place
    and the stale tree slots invalidated;
  * "replay" (SSM and hybrid targets, whose recurrent state has no tree
    analogue): the trunk is scored in one decode from the committed
    snapshot, the branches by replaying from a K-way fork of the
    post-trunk cache, and the commit re-advances the snapshot along the
    accepted path.

It consumes the numpy ``rng`` in exactly the JAX engine's order, so the two
emit the same tokens from the same weights and seed
(tests/test_torch_engine.py, tests/test_torch_replay.py).

Model calls run on the device the weights lie on; warped distributions come
back to the host as float32 numpy, and verification runs on the host
through the core/verify.py registry, or, under
``EngineConfig.verify_on_device`` with a top-down OT verifier, on the
device (core/otlp_device.py), as the JAX engine does.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.otlp_device import verify_topdown
from repro_torch.core.traversal import delayed_structure
from repro_torch.core.trees import DraftTree, tree_ancestor_mask
from repro_torch.core.verify import VERIFIERS, get_verifier
from repro_torch.models.cache import clone_cache, fork_streams
from repro_torch.models.transformer import RECURRENT, forward, init_cache
from repro_torch.sampling import warp_logits
from repro_torch.serving.serve_step import make_pool_commit_step, next_pow2

VERIFIER_DTYPE = np.float64
# the verifiers with an on-device solve (core/otlp_device.py): the top-down OT family
TOPDOWN = frozenset(n for n, s in VERIFIERS.items() if s.on_device)


def to_verifier_dtype(p: np.ndarray) -> np.ndarray:
    """Cast warped target scores to the dtype the host verifiers consume
    (the one verifier-boundary cast)."""
    return np.asarray(p, VERIFIER_DTYPE)


def draw_token(rng: np.random.Generator, dist: np.ndarray) -> int:
    """Sample one token from a warped distribution (the single draw
    primitive: exactness across engines needs identical rng consumption)."""
    return int(rng.choice(len(dist), p=dist / dist.sum()))


def verify_tree(tree: DraftTree, verifier: str, rng: np.random.Generator):
    """Host-side verifier dispatch through the core/verify.py registry.
    Returns (accepted_tokens, correction_token)."""
    return get_verifier(verifier).verify(tree, rng)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


@dataclass
class SamplingParams:
    temperature: float = 1.0
    top_p: float = 1.0


@dataclass
class EngineConfig:
    verifier: str = "specinfer"
    K: int = 2
    L1: int = 2
    L2: int = 2
    max_cache: int = 512
    seed: int = 0
    # top-down OT verifiers verify on the device (core/otlp_device.py);
    # the others stay on the host
    verify_on_device: bool = False


class SpeculativeEngine:
    """Single-stream speculative engine.  The weights' device is the
    engine's device (``init_params`` or ``bridge.params_from_jax`` place
    them)."""

    def __init__(self, target_cfg, target_params, draft_cfg, draft_params, ecfg: EngineConfig,
                 sampling: SamplingParams | None = None, selector=None):
        assert target_cfg.vocab == draft_cfg.vocab
        get_verifier(ecfg.verifier)  # fail loudly on unknown names, at build time
        self.tc, self.tp = target_cfg, target_params
        self.dc, self.dp = draft_cfg, draft_params
        self.device = target_params["embed"].device
        if draft_params["embed"].device != self.device:
            raise ValueError(f"target weights on {self.device}, draft weights on "
                             f"{draft_params['embed'].device}")
        self.ecfg = ecfg
        self.sampling = sampling or SamplingParams()
        self.selector = selector  # callable(stream, engine) -> (K, L1, L2) or None
        self.rng = np.random.default_rng(ecfg.seed)
        self.strategy = "replay" if target_cfg.arch_type in RECURRENT else "tree"
        # latency accounting (model-call counting for the Eq. 11 throughput model)
        self.counters = {"target_calls": 0, "target_tokens": 0, "draft_calls": 0,
                         "draft_tokens": 0, "accepted": 0, "blocks": 0}

    # ------------------------------------------------------------- helpers ---

    def _tokens(self, toks) -> torch.Tensor:
        return torch.as_tensor(np.asarray(toks, np.int64), device=self.device)

    def _warp(self, logits):
        return warp_logits(logits, self.sampling.temperature, self.sampling.top_p)

    def _draft_decode(self, cache, tokens_np):
        """Run the draft model over T committed/drafted tokens. Returns
        (warped dists (T, V) np, new cache, hidden (T, D))."""
        T = len(tokens_np)
        logits, cache, ex = forward(self.dp, self.dc, self._tokens(tokens_np)[None],
                                    mode="decode", cache=cache)
        self.counters["draft_calls"] += 1
        self.counters["draft_tokens"] += T
        return _host(self._warp(logits[0])), cache, _host(ex["hidden"][0])

    def _target_pass_tree(self, cache, tree_tokens, anc):
        T = len(tree_tokens)
        logits, cache, ex = forward(self.tp, self.tc, self._tokens(tree_tokens)[None],
                                    mode="tree", cache=cache,
                                    anc=torch.as_tensor(anc[None], device=self.device))
        self.counters["target_calls"] += 1
        self.counters["target_tokens"] += T
        return _host(self._warp(logits[0])), cache, _host(ex["hidden"][0])

    def _target_decode(self, cache, tokens_np, count=True):
        T = len(tokens_np)
        logits, cache, ex = forward(self.tp, self.tc, self._tokens(tokens_np)[None],
                                    mode="decode", cache=cache)
        if count:
            self.counters["target_calls"] += 1
            self.counters["target_tokens"] += T
        return _host(self._warp(logits[0])), cache, _host(ex["hidden"][0])

    # -------------------------------------------------------------- stream ---

    def new_stream(self, prompt: list[int], enc_embeds=None, embeds=None) -> dict:
        """Prefill prompt[:-1] into both caches; prompt[-1] is the pending root.

        As in the JAX engine, only the target's prefill takes the modality
        inputs (moved to the engine's device): an encdec target always gets
        ``enc_embeds`` (None reads its cache's zero cross K/V), a VLM target
        ``embeds`` when given (prepended patches; with a one-token prompt
        they replace the tokens, unprojected).  The target prefills when
        there is a context or such an input, the draft only on a context."""
        assert len(prompt) >= 1
        tcache = init_cache(self.tc, 1, self.ecfg.max_cache, self.device)
        dcache = init_cache(self.dc, 1, self.ecfg.max_cache, self.device)
        kwargs_t = {}
        if self.tc.arch_type == "encdec":
            kwargs_t["enc_embeds"] = None if enc_embeds is None else torch.as_tensor(enc_embeds, device=self.device)
        if self.tc.arch_type == "vlm" and embeds is not None:
            kwargs_t["embeds"] = torch.as_tensor(embeds, device=self.device)
        ctx = prompt[:-1]
        toks = self._tokens(ctx)[None] if ctx else None
        h_p = h_q = None
        if ctx or kwargs_t:
            _, tcache, ex_t = forward(self.tp, self.tc, toks, mode="full", cache=tcache, **kwargs_t)
            h_p = _host(ex_t["hidden"][0, -1])
        if ctx:
            _, dcache, ex_d = forward(self.dp, self.dc, toks, mode="full", cache=dcache)
            h_q = _host(ex_d["hidden"][0, -1])
        return {
            "tcache": tcache,
            "dcache": dcache,
            "committed": list(prompt),
            "pending": int(prompt[-1]),
            "draft_delta": [int(prompt[-1])],  # tokens the draft hasn't seen
            "h_prev_p": h_p if h_p is not None else np.zeros(self.tc.d_model, np.float32),
            "h_prev_q": h_q if h_q is not None else np.zeros(self.dc.d_model, np.float32),
            "p_prev": None,
            "q_prev": None,
            "done": False,
        }

    # ------------------------------------------------------------ drafting ---

    def _draft_tree(self, stream, K, L1, L2):
        """Draft a (K, L1, L2)-delayed tree.  Returns (tree, root_hidden)."""
        rng = self.rng
        dists, dcache, hid = self._draft_decode(stream["dcache"], stream["draft_delta"])
        # dcache is now committed-consistent (delta tokens are committed):
        # persist it.  The trunk below writes its speculative KV into a copy,
        # since passes write k/v in place and the JAX engine's trunk leaves
        # the persisted cache as it was (with a wrapped ring, trunk slots
        # still hold committed tokens of the persisted cache).  Recurrent
        # draft state comes back as new tensors, so the persisted state
        # stays exact, as on the JAX engine's discarded functional copies.
        stream["dcache"] = dcache
        if L1 > 0:
            dcache = clone_cache(dcache)
        q0 = dists[-1]
        h_cur_q = hid[-1]
        tokens, parent, depth, pid, qs = [-1], [-1], [0], [0], [q0]
        node = 0
        # trunk: sequential single-token drafting
        for _ in range(L1):
            t = draw_token(rng, qs[node])
            d1, dcache, _ = self._draft_decode(dcache, [t])
            tokens.append(t)
            parent.append(node)
            depth.append(depth[node] + 1)
            pid.append(0)
            qs.append(d1[0])
            node = len(tokens) - 1
        branch_node = node
        # branches: fork the draft cache K ways and roll L2 batched steps
        if K > 0 and L2 > 0:
            fork = fork_streams(dcache, K)
            cur_q = np.stack([qs[branch_node]] * K)
            branch_nodes = [branch_node] * K
            for _ in range(L2):
                ts = [draw_token(rng, cur_q[k]) for k in range(K)]
                logits, fork, _ = forward(self.dp, self.dc, self._tokens(ts)[:, None],
                                          mode="decode", cache=fork)
                self.counters["draft_calls"] += 1
                self.counters["draft_tokens"] += K
                dists_b = _host(self._warp(logits[:, 0]))
                for k in range(K):
                    tokens.append(ts[k])
                    parent.append(branch_nodes[k])
                    depth.append(depth[branch_nodes[k]] + 1)
                    pid.append(k)
                    qs.append(dists_b[k])
                    branch_nodes[k] = len(tokens) - 1
        tree = DraftTree(
            tokens=np.asarray(tokens, np.int64),
            parent=np.asarray(parent, np.int64),
            depth=np.asarray(depth, np.int64),
            q=np.stack(qs),
            path_id=np.asarray(pid, np.int64),
        )
        return tree, h_cur_q

    # -------------------------------------------------------------- verify ---

    def _verify(self, tree: DraftTree):
        if self.ecfg.verify_on_device and self.ecfg.verifier in TOPDOWN:
            return self._verify_device(tree, self.ecfg.verifier)
        return verify_tree(tree, self.ecfg.verifier, self.rng)

    def _verify_device(self, tree: DraftTree, solver: str):
        """Whole-tree verification on the engine's device
        (core/otlp_device.verify_topdown).  One draw of the host rng seeds
        the device generator, as the JAX engine draws its key, so the host
        rng stays in step with JAX's; the results come back in one copy."""
        max_depth = int(tree.max_depth()) + 1
        gen = torch.Generator(device=self.device).manual_seed(int(self.rng.integers(2**31)))

        def up(a, dtype):
            return torch.as_tensor(np.asarray(a, dtype), device=self.device)

        out_tok, n_acc, corr = verify_topdown(
            up(tree.tokens, np.int64), up(tree.parent, np.int64), up(tree.p, np.float32),
            up(tree.q, np.float32), gen, solver=solver, max_depth=max_depth, max_children=max(self.ecfg.K, 1))
        res = torch.cat([out_tok, n_acc[None], corr[None]]).tolist()
        return res[:res[max_depth]], res[max_depth + 1]

    @staticmethod
    def _accepted_nodes(tree: DraftTree, accepted: list[int]) -> list[int]:
        """Map the accepted token path -> node indices along the tree.

        Duplicate drafted nodes share a context (and hence KVs/positions), so
        the active *set* is tracked and the first representative is recorded.
        """
        nodes = []
        active = [0]
        for t in accepted:
            kids = [
                i
                for i in range(tree.n_nodes)
                if tree.parent[i] in active and int(tree.tokens[i]) == t
            ]
            nodes.append(kids[0])
            active = kids
        return nodes

    # ------------------------------------------------------------- commits ---

    def _commit_tree_cache(self, cache, C, node_path, T):
        """Copy accepted tree KVs into contiguous committed slots and
        invalidate the remaining tree slots (serve_step.make_pool_commit_step).
        The path is padded to a power of two as in the JAX engine."""
        P = next_pow2(max(1, len(node_path)))
        path = np.zeros((P,), np.int64)
        path[: len(node_path)] = node_path
        commit = make_pool_commit_step(T)
        return commit(cache, self._tokens(path), len(node_path), C)

    # ---------------------------------------------------------------- step ---

    def choose_action(self, stream):
        if self.selector is None:
            return self.ecfg.K, self.ecfg.L1, self.ecfg.L2
        return self.selector(stream, self)

    def step(self, stream) -> list[int]:
        """One speculative decoding iteration; returns newly committed tokens."""
        K, L1, L2 = self.choose_action(stream)
        tree, h_cur_q = self._draft_tree(stream, K, L1, L2)
        C = len(stream["committed"]) - 1  # processed target tokens
        T = tree.n_nodes
        tree_tok = tree.tokens.copy()
        tree_tok[0] = stream["pending"]
        anc = tree_ancestor_mask(tree.parent)

        if self.strategy == "tree":
            p_dists, tcache, hid = self._target_pass_tree(stream["tcache"], tree_tok, anc)
            tree.p = to_verifier_dtype(p_dists)
            accepted, corr = self._verify(tree)
            node_path = self._accepted_nodes(tree, accepted)
            stream["tcache"] = self._commit_tree_cache(tcache, C, node_path, T)
            last_node = node_path[-1] if node_path else 0
            stream["h_prev_p"] = hid[last_node]
        else:
            accepted, corr, hid_last = self._verify_replay(stream, tree, tree_tok)
            stream["h_prev_p"] = hid_last

        stream["p_prev"] = tree.p[self._accepted_nodes(tree, accepted)[-1]] if accepted else tree.p[0]
        stream["q_prev"] = tree.q[self._accepted_nodes(tree, accepted)[-1]] if accepted else tree.q[0]
        new_tokens = list(accepted) + [int(corr)]
        stream["committed"].extend(new_tokens)
        stream["pending"] = int(corr)
        stream["draft_delta"] = new_tokens
        stream["h_prev_q"] = h_cur_q
        self.counters["accepted"] += len(accepted)
        self.counters["blocks"] += 1
        return new_tokens

    # -------------------------------------------------- replay (SSM/hybrid) --

    def _verify_replay(self, stream, tree: DraftTree, tree_tok):
        """Target pass of a recurrent target: the trunk decode from the
        committed snapshot, the branch replay on a K-way fork of the
        post-trunk cache, verification, then the commit: the snapshot
        re-advanced along [root] + accepted.  The trunk runs on a copy of
        the snapshot, since the hybrid's passes write the attention k/v in
        place and the commit decodes from the snapshot as it was (JAX keeps
        it by value)."""
        trunk, _, branches = delayed_structure(tree)
        snapshot = stream["tcache"]
        trunk_tokens = [int(tree_tok[0])] + [int(tree.tokens[v]) for v in trunk]
        p_seq, cache_after_trunk, _ = self._target_decode(clone_cache(snapshot), trunk_tokens)
        p = np.zeros((tree.n_nodes, tree.vocab), VERIFIER_DTYPE)
        p[0] = p_seq[0]
        for i, v in enumerate(trunk):
            p[v] = p_seq[i + 1]
        if branches:
            K = len(branches)
            fork = fork_streams(cache_after_trunk, K)
            btoks = np.asarray([[int(tree.tokens[v]) for v in path] for path in branches], np.int64)
            logits, _, _ = forward(self.tp, self.tc, self._tokens(btoks), mode="decode", cache=fork)
            self.counters["target_calls"] += 1
            self.counters["target_tokens"] += btoks.size
            pb = _host(self._warp(logits))
            for k, path in enumerate(branches):
                for j, v in enumerate(path):
                    p[v] = pb[k, j]
        tree.p = p
        accepted, corr = self._verify(tree)
        commit_toks = [int(tree_tok[0])] + [int(t) for t in accepted]
        _, new_cache, hid = self._target_decode(snapshot, commit_toks, count=False)
        stream["tcache"] = new_cache
        return accepted, int(corr), hid[-1]

    # ------------------------------------------------------- distribution peeks

    def peek_draft_dist(self, stream, ctx: list[int]) -> np.ndarray:
        """q(. | committed + ctx) without mutating the stream (on a copy)."""
        toks = list(stream["draft_delta"]) + list(ctx)
        dists, _, _ = self._draft_decode(clone_cache(stream["dcache"]), toks)
        return dists[-1]

    def peek_target_dist(self, stream, ctx: list[int]) -> np.ndarray:
        """p(. | committed + ctx) without mutating the stream (on a copy)."""
        toks = [stream["pending"]] + list(ctx)
        dists, _, _ = self._target_decode(clone_cache(stream["tcache"]), toks)
        return dists[-1]

    # ------------------------------------------------------------ generate ---

    def generate(self, prompt: list[int], max_new: int = 64, **kw) -> list[int]:
        """``kw``: ``new_stream``'s ``enc_embeds`` / ``embeds``."""
        stream = self.new_stream(prompt, **kw)
        out: list[int] = []
        while len(out) < max_new:
            out.extend(self.step(stream))
        return out[:max_new]
