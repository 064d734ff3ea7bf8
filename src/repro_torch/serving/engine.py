"""Speculative-decoding engine: delayed-tree drafting + tree-masked target
pass + lossless verification, with optional action selection.

The counterpart of ``SpeculativeEngine`` in src/repro/serving/engine.py with
the "tree" target-pass strategy (attention-based targets): one pass over the
speculation block with the ancestor mask, then the accepted KVs are
committed in place and the stale tree slots invalidated.  It consumes the
numpy ``rng`` in exactly the JAX engine's order, so the two emit the same
tokens from the same weights and seed (tests/test_torch_engine.py).

Model calls run on the device the weights lie on; warped distributions come
back to the host as float32 numpy, and verification runs on the host
through the core/verify.py registry.  The "replay" strategy (SSM/hybrid
targets) and on-device verification are not ported yet and raise.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.trees import DraftTree, tree_ancestor_mask
from repro_torch.core.verify import get_verifier
from repro_torch.models.cache import clone_cache, fork_streams
from repro_torch.models.transformer import forward, init_cache
from repro_torch.sampling import warp_logits
from repro_torch.serving.serve_step import make_pool_commit_step, next_pow2

VERIFIER_DTYPE = np.float64


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
    # on-device OT verification (the JAX package's core/otlp_jax.py path)
    verify_on_device: bool = False


class SpeculativeEngine:
    """Single-stream speculative engine.  The weights' device is the
    engine's device (``init_params`` or ``bridge.params_from_jax`` place
    them)."""

    def __init__(self, target_cfg, target_params, draft_cfg, draft_params, ecfg: EngineConfig,
                 sampling: SamplingParams | None = None, selector=None):
        assert target_cfg.vocab == draft_cfg.vocab
        get_verifier(ecfg.verifier)  # fail loudly on unknown names, at build time
        if target_cfg.arch_type in ("ssm", "hybrid"):
            raise NotImplementedError(
                "the replay target-pass strategy (SSM/hybrid targets) is not ported: "
                "ROADMAP queue 1 item 9")
        if ecfg.verify_on_device:
            raise NotImplementedError("on-device verification is not ported: ROADMAP queue 1 item 11")
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

    def _target_decode(self, cache, tokens_np):
        T = len(tokens_np)
        logits, cache, ex = forward(self.tp, self.tc, self._tokens(tokens_np)[None],
                                    mode="decode", cache=cache)
        self.counters["target_calls"] += 1
        self.counters["target_tokens"] += T
        return _host(self._warp(logits[0])), cache, _host(ex["hidden"][0])

    # -------------------------------------------------------------- stream ---

    def new_stream(self, prompt: list[int]) -> dict:
        """Prefill prompt[:-1] into both caches; prompt[-1] is the pending root."""
        assert len(prompt) >= 1
        tcache = init_cache(self.tc, 1, self.ecfg.max_cache, self.device)
        dcache = init_cache(self.dc, 1, self.ecfg.max_cache, self.device)
        ctx = prompt[:-1]
        h_p = h_q = None
        if ctx:
            toks = self._tokens(ctx)[None]
            _, tcache, ex_t = forward(self.tp, self.tc, toks, mode="full", cache=tcache)
            h_p = _host(ex_t["hidden"][0, -1])
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
        # still hold committed tokens of the persisted cache).
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
        return verify_tree(tree, self.ecfg.verifier, self.rng)

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

        p_dists, tcache, hid = self._target_pass_tree(stream["tcache"], tree_tok, anc)
        tree.p = to_verifier_dtype(p_dists)
        accepted, corr = self._verify(tree)
        node_path = self._accepted_nodes(tree, accepted)
        stream["tcache"] = self._commit_tree_cache(tcache, C, node_path, T)
        last_node = node_path[-1] if node_path else 0
        stream["h_prev_p"] = hid[last_node]

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

    def generate(self, prompt: list[int], max_new: int = 64) -> list[int]:
        stream = self.new_stream(prompt)
        out: list[int] = []
        while len(out) < max_new:
            out.extend(self.step(stream))
        return out[:max_new]
