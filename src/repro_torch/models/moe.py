"""Mixture-of-Experts FFN with capacity-based dispatch (granite, kimi-k2), the
port of the JAX package's ``models/moe.py``.

Tokens are grouped (G groups, by default the batch rows); each group routes
top-k in f32, ranks its (token, expert) pairs within each expert by a stable
sort on the expert id, and scatters its tokens into a (G, E, C, D) dispatch
buffer.  Pairs ranked past the logical capacity C_drop = ceil(T_g * k * cf /
E) are dropped (Switch/GShard semantics): they go to a spare slot C of the
buffer, which is sliced off after the scatter and reads back as zero in the
gather (the JAX package's out-of-bounds ``mode="drop"`` / ``mode="fill"``).
The experts run expert-major, (E, G * C, D).

Top-k breaks ties toward the lower expert index, as ``jax.lax.top_k`` does:
the port sorts the probabilities with a stable descending sort and keeps the
first k.  The JAX package's custom-VJP gathers exist only to keep XLA from
turning a gather's transpose into a one-hot product; PyTorch's gather and
index backward already scatter-add, so the port indexes plainly.
``moe_apply_dense`` is the oracle for tests.

Under a mesh (``tp``, a ``layers.TensorParallel``) the block runs on this
rank's tokens, the JAX package's ``expert_group`` / ``moe_dispatch`` /
``expert`` constraints made explicit.  Routing stays group-local: the groups
are the batch rows, so a rank holding B/D rows holds B/D whole groups and
sharding changes no routing decision (every ``model`` rank routes its
tokens alike).  Where ``data`` divides the experts (``w_gate`` cut over
``data``) the (G_local, E, C, D) buffer goes through an all-to-all over
``data`` -- E split, G concatenated -- to (G, E/D, C, D), the slots of this
rank's experts, and back after the experts (expert parallelism); where it
does not, or where the rules cut no experts over ``data`` (``fsdp``,
``zero2``: ``TensorParallel.expert_split``), the experts are whole on every
rank (gathered where they are stored cut) and the block stays
device-local.  The experts' F dim cut over ``model`` runs column- then
row-parallel (a copy in, a psum out).  The load-balancing loss is the global
batch's: the expert counts and the mean router probabilities are summed
over the batch axes before their product is formed.

:func:`routings` collects each routing's experts and each token's gap
between its k-th and (k+1)-th router probability: a token whose gap lies
within the rounding of the block input (a psum over ``model`` moves it by
ulps) may pick another expert on a mesh than on one device, which the
experts picked on each show.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _device, _empty_or, dense_init


def moe_init(generator, cfg, dtype=torch.float32, device=None, lead: tuple = ()):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    dev = _device(generator, device)

    def experts(shape, fan_in):
        w = _empty_or(generator, lead + shape, dtype, dev)
        return w.mul_(fan_in ** -0.5) if generator is not None else w

    return {
        "router": dense_init(generator, d, e, dtype=torch.float32, device=device,
                             lead=lead),                       # router kept f32
        "w_gate": experts((e, d, f), d),
        "w_up": experts((e, d, f), d),
        "w_down": experts((e, f, d), f),
    }


_ROUTINGS: list | None = None


@contextlib.contextmanager
def routings():
    """Within the block, every routing appends to the list this yields a
    pair: each token's k-th minus its (k+1)-th router probability, f32 (T,),
    and the k experts it picked, (T, k) in descending probability."""
    global _ROUTINGS
    prev, _ROUTINGS = _ROUTINGS, []
    try:
        yield _ROUTINGS
    finally:
        _ROUTINGS = prev


def _route(p, x2d, cfg):
    """x2d: (T, D) -> (weights (T, k), idx (T, k), probs (T, E)). f32 router."""
    logits = x2d.to(torch.float32) @ p["router"]["w"]
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.num_experts_per_tok
    if _ROUTINGS is not None and k < cfg.num_experts:
        _ROUTINGS.append(((topw[:, k - 1] - topw[:, k]).detach(), topi[:, :k]))
    topw, topi = topw[:, :k], topi[:, :k]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return topw, topi, probs


def _logical_capacity(tokens_per_group: int, cfg) -> int:
    """Expert capacity in the Switch/GShard sense: tokens ranked past this are
    dropped. ceil(T_g * k * cf / E), at least 1."""
    c = -(-(tokens_per_group * cfg.num_experts_per_tok * cfg.capacity_factor)
          // cfg.num_experts)
    return max(1, int(c))


def _capacity(tokens_per_group: int, cfg) -> int:
    """Dispatch-buffer slots per expert: the logical capacity padded up to a
    multiple of 8 (at least 8).  The drop decision uses
    :func:`_logical_capacity`."""
    c = _logical_capacity(tokens_per_group, cfg)
    return max(8, -(-c // 8) * 8)


def _expert_ffn(p, xe, cfg, compute_dtype):
    """xe: (E, N, D) -> (E, N, D); per-expert SwiGLU."""
    cd = compute_dtype or xe.dtype
    xe = xe.to(cd)
    wg, wu, wd = p["w_gate"].to(cd), p["w_up"].to(cd), p["w_down"].to(cd)
    h = F.silu(torch.einsum("end,edf->enf", xe, wg))
    h = h * torch.einsum("end,edf->enf", xe, wu)
    return torch.einsum("enf,efd->end", h, wd)


def _experts(p, buf, cfg, compute_dtype, tp):
    """The experts on the dispatch buffer (G, E, C, D), expert-major.  Under
    ``tp`` on this rank's buffer: its experts' slots of every group of the
    ``data`` axis fetched by an all-to-all where ``data`` cuts the experts
    (else the experts gathered whole, :meth:`layers.TensorParallel.weight`),
    the F dim column- then row-parallel where ``model`` cuts it, the outputs
    sent back."""
    ep = f_split = False
    if tp is not None:
        sp = tp.specs["moe"]
        ep = tp.expert_split and tp.split(sp["w_gate"], 0, "data")
        f_split = tp.split(sp["w_gate"], 2)
        if not ep:
            p = {k: tp.weight(p[k], sp[k]) for k in ("w_gate", "w_up", "w_down")}
    if ep:
        buf = tp.data.all_to_all(buf, 1, 0)                       # (G, E/D, C, D)
    g, e, c, d = buf.shape
    xe = buf.permute(1, 0, 2, 3).reshape(e, g * c, d)
    if f_split:
        xe = tp.model.copy(xe)
    ye = _expert_ffn(p, xe, cfg, compute_dtype)
    if f_split:
        ye = tp.model.all_reduce(ye)
    out = ye.reshape(e, g, c, d).permute(1, 0, 2, 3)
    return tp.data.all_to_all(out, 0, 1) if ep else out            # (G_local, E, C, D)


def _load(probs, counts, t, k, tp):
    """(f_e, p_e) of the load-balancing loss: the share of the k * T
    assignments each expert got and its mean router probability, over the
    global batch under ``tp`` (a psum over each batch axis; the ranks hold
    equal numbers of tokens, so the global mean is the mean of theirs)."""
    me = probs.mean(dim=(0, 1))
    cnt, n = counts.sum(dim=0), t * k
    for ax in () if tp is None else [a for a in tp.batch if a.size > 1]:
        me = ax.all_reduce(me) / ax.size
        cnt, n = ax.all_reduce(cnt), n * ax.size
    return cnt.to(torch.float32) / n, me


def moe_apply(p, x, cfg, *, num_groups: int | None = None, compute_dtype=None,
              tp=None, aux_loss: bool = True):
    """x: (B, S, D) -> (y (B, S, D), aux_loss scalar).

    ``num_groups`` defaults to the batch dim; it must divide B * S.  The
    load-balancing aux loss is Switch's E * sum_e f_e * p_e (zero without
    ``aux_loss``: a decode step's).  Under ``tp`` on this rank's tokens and
    expert shards, the aux loss the global batch's.
    """
    b, s, d = x.shape
    t = b * s
    g = num_groups or b
    assert t % g == 0, (t, g)
    tg = t // g
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    c = _capacity(tg, cfg)               # buffer slots
    c_drop = _logical_capacity(tg, cfg)  # rank threshold for dropping
    tk = tg * k
    dev = x.device

    xg = x.reshape(g, tg, d)
    topw, topi, probs = _route(p, xg.reshape(t, d), cfg)
    topw = topw.reshape(g, tg, k)
    flat_e = topi.reshape(g, tk)                                   # (G, Tk)

    counts = torch.zeros((g, e), dtype=torch.long, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))                        # (G, E)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    if aux_loss:
        fe, me = _load(probs.reshape(g, tg, e), counts, t, k, tp)
        aux = e * torch.sum(fe * me)

    # rank of each pair within its (group, expert), from the sorted order
    sort_idx = torch.argsort(flat_e, dim=1, stable=True)           # (G, Tk)
    sorted_e = torch.gather(flat_e, 1, sort_idx)
    offsets = torch.cumsum(counts, dim=1) - counts                 # exclusive
    rank_sorted = (torch.arange(tk, device=dev)[None, :]
                   - torch.gather(offsets, 1, sorted_e))
    slot_sorted = torch.where(rank_sorted < c_drop, rank_sorted,
                              torch.full_like(rank_sorted, c))     # c: the spare slot

    # gather tokens in sorted order, scatter them into the dispatch buffer
    tok_sorted = sort_idx // k
    x_sorted = torch.gather(xg, 1, tok_sorted[..., None].expand(g, tk, d))
    gi = torch.arange(g, device=dev)[:, None].expand(g, tk)
    buf = x_sorted.new_zeros((g, e, c + 1, d)).index_put(
        (gi, sorted_e, slot_sorted), x_sorted)[:, :, :c]           # (G, E, C, D)

    out_buf = _experts(p, buf, cfg, compute_dtype, tp)              # (G, E, C, D)

    # each pair's expert output (dropped -> the zero spare slot), unsorted
    out_buf = F.pad(out_buf, (0, 0, 0, 1))
    y_sorted = out_buf[gi, sorted_e, slot_sorted]                  # (G, Tk, D)
    inv = torch.argsort(sort_idx, dim=1)
    y_tok = torch.gather(y_sorted, 1, inv[..., None].expand(g, tk, d))
    w_flat = topw.reshape(g, tk).to(y_tok.dtype)
    y = (y_tok * w_flat[..., None]).reshape(g, tg, k, d).sum(dim=2)
    return y.reshape(b, s, d).to(x.dtype), aux


def moe_apply_dense(p, x, cfg, compute_dtype=None):
    """Dense oracle: every expert on every token, exact top-k combine (no
    capacity drops). O(T * E * F) -- tests only."""
    b, s, d = x.shape
    t = b * s
    x2 = x.reshape(t, d)
    topw, topi, _ = _route(p, x2, cfg)
    ye = _expert_ffn(p, x2.expand(cfg.num_experts, t, d), cfg, compute_dtype)
    sel = ye[topi, torch.arange(t, device=x.device)[:, None]]     # (T, k, D)
    y = (sel * topw[..., None].to(sel.dtype)).sum(dim=1)
    return y.reshape(b, s, d).to(x.dtype)
