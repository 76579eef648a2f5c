"""The Merkle tree and the verifier's path walk, one layer or one parent step
at a time over any digest's layer and parent functions (the construction of
lcpc-2d/src/lib.rs:665-704, 955-982).

These loops are the plain versions of the one-launch tree and walk kernels
of both digests (csrc/merkle.cuh; ops/blake3.py and ops/sha256.py:
`merkle_tree_plain`, `merkle_walk_plain`).  Digests are (8, n) int64
tensors holding u32 words.
"""

from __future__ import annotations

import torch


def tree_by_layers(leaves: torch.Tensor, n_cols_np2: int, layer) -> torch.Tensor:
    """Leaves (8, n_cols) zero-padded to n_cols_np2, then every layer
    `layer` makes, flattened leaves first: (8, 2 n_cols_np2 - 1) int64."""
    n_cols = leaves.shape[1]
    if n_cols_np2 > n_cols:  # zero digests pad the leaves (lib.rs:665)
        leaves = torch.nn.functional.pad(leaves, (0, n_cols_np2 - n_cols))
    layers = [leaves.to(torch.int64)]
    while layers[-1].shape[1] > 1:
        layers.append(layer(layers[-1]))
    return torch.cat(layers, dim=1)


def walk_by_parents(digs: torch.Tensor, uniq_sibs: torch.Tensor, inv: torch.Tensor,
                    idx: torch.Tensor, parent) -> torch.Tensor:
    """Walk each opened column's path to the root: digs (8, k) column
    digests, uniq_sibs (8, U) sibling digests, inv (L, k) the sibling of
    column j at level l, idx (k,) the columns' indices (bit l: the node is
    a right child).  Returns the (8, k) roots the paths reach."""
    for lvl in range(inv.shape[0]):
        s = uniq_sibs.index_select(1, inv[lvl])
        is_right = ((idx >> lvl) & 1).bool()
        digs = parent(torch.where(is_right, s, digs), torch.where(is_right, digs, s))
    return digs
