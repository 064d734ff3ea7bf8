"""Draft-tree data structures.

A draft tree (Def. 3.1) is stored flat:  node 0 is the root (the current
context head, no token of its own); every other node ``i`` holds the token
that extends its parent's context.  Drafted paths are kept *unmerged*: if two
i.i.d. paths draw the same token under the same parent they remain separate
nodes.  This is exactly the multiset child-list semantics of Def. 3.1 — every
algorithm here treats the child list of a context as the multiset of child
tokens across all drafted nodes sharing that context (the "active set" of
nodes that represent it).

Delayed trees (Def. 5.2) are the (K, L1, L2) family: a trunk path of length
L1 followed by K i.i.d. branches of length L2.  K=?, L1=0 recovers plain
i.i.d. root rollouts; K=1 recovers a single path of length L1+L2.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class DraftTree:
    """Flat draft tree.  N nodes including the root (index 0).

    tokens[i]  : token extending parent context (tokens[0] is unused, -1)
    parent[i]  : parent node index (parent[0] == -1)
    depth[i]   : root-distance (depth[0] == 0)
    q[i]       : draft next-token distribution *at* node i's context, shape (V,)
    p[i]       : target next-token distribution at node i's context, shape (V,)
    """

    tokens: np.ndarray
    parent: np.ndarray
    depth: np.ndarray
    q: np.ndarray
    p: np.ndarray | None = None
    # path order for traversal tie-breaks: order[i] = index of the drafted
    # path that created node i (trunk nodes get 0).
    path_id: np.ndarray | None = None

    @property
    def n_nodes(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def vocab(self) -> int:
        return int(self.q.shape[-1])

    def children(self, node: int) -> list[int]:
        return [i for i in range(self.n_nodes) if self.parent[i] == node]

    def children_of_set(self, nodes: list[int]) -> list[int]:
        s = set(nodes)
        return [i for i in range(self.n_nodes) if self.parent[i] in s]

    def path_tokens(self, node: int) -> list[int]:
        out = []
        while node != 0:
            out.append(int(self.tokens[node]))
            node = int(self.parent[node])
        return out[::-1]

    def max_depth(self) -> int:
        return int(self.depth.max())


def delayed_tree_node_count(K: int, L1: int, L2: int) -> int:
    return 1 + L1 + K * L2


def build_delayed_tree(
    rng: np.random.Generator,
    q_fn,
    K: int,
    L1: int,
    L2: int,
    root_context: tuple[int, ...] = (),
) -> DraftTree:
    """Draft a (K, L1, L2)-delayed tree from draft model ``q_fn``.

    ``q_fn(context_tuple) -> (V,) numpy distribution``.  Host-side reference
    implementation used by the algorithm library and tests; the serving
    engine has a batched JAX equivalent.
    """
    tokens = [-1]
    parent = [-1]
    depth = [0]
    pid = [0]
    qs = [np.asarray(q_fn(root_context), dtype=np.float64)]

    def _sample(dist):
        return int(rng.choice(len(dist), p=dist / dist.sum()))

    # trunk
    ctx = tuple(root_context)
    node = 0
    for _ in range(L1):
        t = _sample(qs[node])
        ctx = ctx + (t,)
        tokens.append(t)
        parent.append(node)
        depth.append(depth[node] + 1)
        pid.append(0)
        qs.append(np.asarray(q_fn(ctx), dtype=np.float64))
        node = len(tokens) - 1
    branch_node, branch_ctx = node, ctx
    # K i.i.d. branches
    for k in range(K):
        node, ctx = branch_node, branch_ctx
        for _ in range(L2):
            t = _sample(qs[node])
            ctx = ctx + (t,)
            tokens.append(t)
            parent.append(node)
            depth.append(depth[node] + 1)
            pid.append(k)
            qs.append(np.asarray(q_fn(ctx), dtype=np.float64))
            node = len(tokens) - 1
    return DraftTree(
        tokens=np.asarray(tokens, dtype=np.int64),
        parent=np.asarray(parent, dtype=np.int64),
        depth=np.asarray(depth, dtype=np.int64),
        q=np.stack(qs, axis=0),
        path_id=np.asarray(pid, dtype=np.int64),
    )


def attach_target(tree: DraftTree, p_fn, root_context: tuple[int, ...] = ()) -> DraftTree:
    """Fill ``tree.p`` by evaluating the target distribution at every node
    (the host-side analogue of the batched tree-attention target pass)."""
    ps = []
    for i in range(tree.n_nodes):
        ctx = tuple(root_context) + tuple(tree.path_tokens(i))
        ps.append(np.asarray(p_fn(ctx), dtype=np.float64))
    tree.p = np.stack(ps, axis=0)
    return tree


def tree_ancestor_mask(parent: np.ndarray) -> np.ndarray:
    """(N, N) boolean mask: mask[i, j] == True iff j is an ancestor of i or i==j.

    This is the attention mask of the speculation block in the target tree
    pass (token i may attend to token j).
    """
    n = parent.shape[0]
    mask = np.eye(n, dtype=bool)
    for i in range(n):
        j = int(parent[i])
        while j >= 0:
            mask[i, j] = True
            j = int(parent[j])
    return mask
