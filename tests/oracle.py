"""Pure-numpy oracles for model parity (SURVEY.md §4: per-layer
activation parity). These re-implement DGL SAGEConv('mean') /
GraphConv(norm='both') semantics on a decoded edge list, independently of
the JAX code paths under test. Edge lists are ``[(src_pos, dst_pos),
...]`` or an (E, 2) integer array; arithmetic runs in the inputs' dtype
(pass float64 for a reference at full precision)."""

import numpy as np


def decode_block(batch, blk):
    """Return (edges (E, 2) array of (src_pos, dst_pos), num_src,
    num_dst)."""
    pos = np.asarray(blk.nbr_pos)
    mask = np.asarray(blk.nbr_mask)
    dst = np.broadcast_to(np.arange(pos.shape[0])[:, None], pos.shape)
    edges = np.stack([pos[mask], dst[mask]], axis=1)
    return edges, int(blk.num_src), int(blk.num_dst)


def _edges(edges):
    e = np.asarray(edges, np.int64).reshape(-1, 2)
    return e[:, 0], e[:, 1]


def _mean_agg(h_src, edges, dst_cap):
    src, dst = _edges(edges)
    agg = np.zeros((dst_cap, h_src.shape[1]), h_src.dtype)
    np.add.at(agg, dst, h_src[src])
    cnt = np.bincount(dst, minlength=dst_cap).astype(h_src.dtype)
    return agg / np.maximum(cnt, 1)[:, None]


def _gcn_agg(h_src, edges, src_cap, dst_cap):
    src, dst = _edges(edges)
    out_deg = np.bincount(src, minlength=src_cap).astype(h_src.dtype)
    in_deg = np.bincount(dst, minlength=dst_cap).astype(h_src.dtype)
    h = h_src * (1.0 / np.sqrt(np.maximum(out_deg, 1)))[:, None]
    agg = np.zeros((dst_cap, h.shape[1]), h.dtype)
    np.add.at(agg, dst, h[src])
    return agg * (1.0 / np.sqrt(np.maximum(in_deg, 1)))[:, None]


def sage_conv_np(h_src, edges, dst_cap, w_self, b_self, w_neigh):
    agg = _mean_agg(h_src, edges, dst_cap)
    return h_src[:dst_cap] @ w_self + b_self + agg @ w_neigh


def sage_conv_grads_np(h_src, edges, dst_cap, r):
    """Parameter gradients of sum(sage_conv_np(...) * r)."""
    agg = _mean_agg(h_src, edges, dst_cap)
    return {"fc_self": {"kernel": h_src[:dst_cap].T @ r,
                        "bias": r.sum(0)},
            "fc_neigh": {"kernel": agg.T @ r}}


def gcn_conv_np(h_src, edges, src_cap, dst_cap, w, b):
    return _gcn_agg(h_src, edges, src_cap, dst_cap) @ w + b


def gcn_conv_grads_np(h_src, edges, src_cap, dst_cap, r):
    """Parameter gradients of sum(gcn_conv_np(...) * r)."""
    agg = _gcn_agg(h_src, edges, src_cap, dst_cap)
    return {"dense": {"kernel": agg.T @ r}, "bias": r.sum(0)}
