"""Tensor-parallel collectives along ``model``: the port's counterpart of
the collectives that the reference's SPMD partitioner inserts where its
sharding rules (``parallel/sharding.py``) split a contraction.

The Megatron pattern, as a conjugate pair of ``torch.autograd.Function``s:

* :func:`copy_to_model`: the identity forward, an ``all_reduce`` of the
  gradient backward; it stands before a column-parallel product, whose
  input every model rank holds whole and whose input gradient each rank
  holds a part of;
* :func:`reduce_from_model`: an ``all_reduce`` forward, the identity
  backward; it follows a row-parallel product, whose output each rank
  holds a part of.

Where the rules cut a projection's columns into part of a head (8 KV
heads of 128 over 16 ranks: 64 columns, half a head), the columns are
joined whole on every rank (:func:`join_heads`: an exact join forward;
backward, the gradient summed over ``model``, then this rank's block), so
RoPE and the q/k norms read whole heads and the cache holds every KV head,
as ``cache_specs`` keeps them; a rank then attends with the query heads
that cover its ``wo`` rows (:func:`query_heads`) against the KV heads
they read (:func:`kv_heads`).

A tail block (``tail_pattern``), whose unstacked 2-D leaves the rules cut
differently (``wq``/``wk``/``wv`` and ``w_in``/``w_gate`` whole, ``wo``
and ``w_out`` on their output dim), computes its projections whole on
every rank, attends on this rank's heads (:func:`own_part`, as its cache
holds them), and joins the heads and the output columns exactly
(:func:`gather_from_model`: a join forward, this rank's block of the
gradient backward).

The vocabulary is cut over ``model`` in both ``embed/table`` and
``head/w`` (rows of the table, columns of the head):

* :func:`embed_lookup`: ids outside this rank's rows give zeros, then one
  ``all_reduce`` (a sum of one row and zeros: the row's bits);
* :func:`vocab_logits`: the head on this rank's vocabulary slice;
* :func:`join_vocab`: a slice of logits joined into the full row on every
  model rank, bit for bit (``comm``'s exact join), for the server's host
  argmax and its sampling;
* :func:`lse_and_gold`: the log-partition and the label's logit over
  vocab-sharded logits: the row max over the ranks (``comm.all_reduce_max``),
  the sum of exponentials by ``all_reduce``, the label's logit from the rank
  that holds it, all on the autograd path.

Every collective goes through ``parallel.comm``, so its counters (and the
dry run's) see it.  Outside a model-shard context
(``sharding.model_shard``), every function here is the plain computation
and issues no collective.  A gradient's ``all_reduce`` reads the group the
forward saw, so it runs on autograd's thread as well.
"""

from __future__ import annotations

import torch

from repro_torch.parallel import comm
from repro_torch.parallel.sharding import current_model_shard


def splits(n: int) -> bool:
    """Whether a dim of size ``n`` is cut over ``model`` here: inside a
    model-shard context, when the axis divides it (the sharding rules'
    divisibility guard)."""
    ms = current_model_shard()
    return ms is not None and n % ms.tp == 0


def local(n: int) -> int:
    """This rank's part of a dim of size ``n`` that the rules cut over
    ``model`` (``n`` itself where :func:`splits` does not hold)."""
    return n // current_model_shard().tp if splits(n) else n


def attn_splits(cfg) -> bool:
    """Whether attention computes on this rank's part: ``attn_tp`` and the
    rules cutting ``wq``'s and ``wk``/``wv``'s columns (a ``cross``
    block's are the same counts), in whole heads or not; under MLA whole
    query heads (its latent stays whole).  ``sharding.
    computes_on_model_shard`` admits no other split."""
    if not cfg.attn_tp:
        return False
    if cfg.use_mla:
        return splits(cfg.n_heads)
    return splits(cfg.n_heads * cfg.head_dim) and splits(cfg.n_kv_heads * cfg.head_dim)


def query_heads(index: int, cols: int, hd: int) -> tuple[int, int, int]:
    """``(h0, h1, offset)``: the query heads ``[h0, h1)`` whose columns
    cover block ``index`` of ``cols`` columns (``wo``'s rows on model rank
    ``index``, ``hd`` columns a head), and the block's first column within
    them."""
    start = index * cols
    h0 = start // hd
    return h0, -(-(start + cols) // hd), start - h0 * hd


def kv_heads(h0: int, h1: int, n_heads: int, n_kv: int) -> list[int]:
    """The KV heads that query heads ``[h0, h1)`` read (head ``h`` reads
    ``h // (n_heads / n_kv)``), listed so that the attention core's GQA map
    (local query head ``j`` reads entry ``j // ((h1 - h0) / len)``) is
    right: the contiguous heads read where the query heads group evenly
    over them, else one entry a query head."""
    group = n_heads // n_kv
    read = [h // group for h in range(h0, h1)]
    heads = sorted(set(read))
    per = (h1 - h0) // len(heads)
    if per * len(heads) == h1 - h0 and all(r == heads[j // per] for j, r in enumerate(read)):
        return heads
    return read


def own_range(held: int, n: int) -> tuple[int, int]:
    """``[e0, e1)``: the indices of a dim of size ``n`` (the experts) of
    which this rank holds ``held``, its contiguous block over ``model``;
    ``(0, n)`` where the dim is whole here."""
    if held == n:
        return 0, n
    ms = current_model_shard()
    if ms is None or held * ms.tp != n:
        raise ValueError(f"a block of {held} is not this rank's 1/tp of {n}")
    return ms.index * held, (ms.index + 1) * held


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return comm.all_reduce(grad.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return comm.all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel product: ``x`` forward; its gradient
    summed over ``model`` backward."""
    ms = current_model_shard()
    if ms is None or not _needs_grad(x):
        return x
    return _CopyToModel.apply(x, ms.group)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The output of a row-parallel product: ``x`` summed over ``model``
    forward; its gradient as it is backward."""
    ms = current_model_shard()
    if ms is None:
        return x
    if _needs_grad(x):
        return _ReduceFromModel.apply(x, ms.group)
    return comm.all_reduce(x.contiguous().clone(), ms.group)


def _join_last(x: torch.Tensor, ms, kind: str) -> torch.Tensor:
    """This rank's last-dim block of ``x`` joined over ``model`` into the
    whole, on every rank, bit for bit (``comm``'s exact join)."""
    t = x.movedim(-1, 0).contiguous()
    return comm.gather_rows_exact(t, ms.index, ms.tp, ms.group, kind=kind).movedim(0, -1)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ms):
        ctx.index, ctx.n = ms.index, x.shape[-1]
        return _join_last(x, ms, "gather_cols").contiguous()

    @staticmethod
    def backward(ctx, grad):
        return grad[..., ctx.index * ctx.n:(ctx.index + 1) * ctx.n], None


def gather_from_model(x: torch.Tensor) -> torch.Tensor:
    """An activation's last dim, of which this rank holds its block, joined
    whole on every model rank, bit for bit (counted as ``gather_cols``);
    backward, this rank's block of the gradient (which every model rank
    holds whole)."""
    ms = current_model_shard()
    if ms is None:
        return x
    if _needs_grad(x):
        return _GatherFromModel.apply(x, ms)
    return _join_last(x.detach(), ms, "gather_cols")


class _JoinHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ms):
        ctx.index, ctx.n, ctx.group = ms.index, x.shape[-1], ms.group
        return _join_last(x, ms, "gather_heads").contiguous()

    @staticmethod
    def backward(ctx, grad):
        # ranks whose query heads read the same KV head each hold a part
        # of its gradient: the sum over model, then this rank's block
        total = comm.all_reduce(grad.contiguous().clone(), ctx.group)
        return total[..., ctx.index * ctx.n:(ctx.index + 1) * ctx.n], None


def join_heads(*xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Projections of one leading shape, of each of which this rank holds
    its block of columns (part of a head), each joined whole on every model
    rank, bit for bit, in one collective (counted as ``gather_heads``);
    backward, the gradient summed over ``model``, then this rank's block
    (each rank's whole gradient is its heads' part only, unlike
    :func:`gather_from_model`'s)."""
    ms = current_model_shard()
    if ms is None:
        return xs
    cols = [x.shape[-1] for x in xs]
    x = torch.cat(xs, -1) if len(xs) > 1 else xs[0]
    if _needs_grad(x):
        full = _JoinHeads.apply(x, ms)
    else:
        full = _join_last(x.detach(), ms, "gather_heads")
    # rank blocks of [x0 | x1 | ...] side by side: each x's blocks in rank order
    full = full.unflatten(-1, (ms.tp, sum(cols)))
    return tuple(t.reshape(*t.shape[:-2], -1) for t in full.split(cols, -1))


def own_part(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block of dim ``dim`` of an activation every model rank
    computes whole (whole heads of a projection whose weights stay whole);
    backward, the blocks' gradients summed over ``model``, so the whole
    activation's gradient is complete on every rank."""
    ms = current_model_shard()
    n = x.shape[dim] // ms.tp
    return copy_to_model(x).narrow(dim, ms.index * n, n)


def _vocab_start(rows: int, vocab: int) -> int | None:
    """The first vocabulary id of this rank's ``rows`` of ``vocab``, or
    None where the vocabulary is whole here."""
    ms = current_model_shard()
    if ms is None or rows == vocab:
        return None
    if rows * ms.tp != vocab:
        raise ValueError(f"a vocabulary slice of {rows} rows is not 1/{ms.tp} of {vocab}")
    return ms.index * rows


def embed_lookup(table: torch.Tensor, ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """``table[ids]`` of this rank's ``table`` rows: zeros for ids held by
    another rank, then one ``all_reduce`` over ``model``."""
    start = _vocab_start(table.shape[0], vocab)
    if start is None:
        return table[ids]
    rows = table.shape[0]
    at = ids - start
    inside = (at >= 0) & (at < rows)
    x = torch.where(inside[..., None], table[at.clamp(0, rows - 1)], 0.0)
    return reduce_from_model(x)


def vocab_logits(h: torch.Tensor, w: torch.Tensor, vocab: int, *, tied: bool) -> torch.Tensor:
    """The logits head on this rank's vocabulary: ``h @ w.T`` for a tied
    table ``[V, D]``, ``h @ w`` for a head ``[D, V]``; the last dim is this
    rank's slice when the vocabulary is cut."""
    if _vocab_start(w.shape[0] if tied else w.shape[-1], vocab) is not None:
        h = copy_to_model(h)
    return h @ w.T if tied else h @ w


def join_vocab(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """The full rows of a slice of logits ``[..., V/tp]``, on every model
    rank, bit for bit (counted as ``gather_vocab``); a whole row as it is."""
    start = _vocab_start(logits.shape[-1], vocab)
    if start is None:
        return logits
    return _join_last(logits.detach(), current_model_shard(), "gather_vocab")


def lse_and_gold(logits: torch.Tensor, labels: torch.Tensor, vocab: int):
    """``(logsumexp over the vocabulary, the label's logit)`` of fp32
    logits whose last dim may be this rank's slice, both on the autograd
    path; ``labels`` below 0 read id 0 (the caller masks them)."""
    gold_ids = labels.clamp(min=0)
    start = _vocab_start(logits.shape[-1], vocab)
    if start is None:
        lse = torch.logsumexp(logits, dim=-1)
        return lse, torch.gather(logits, -1, gold_ids[..., None])[..., 0]
    ms = current_model_shard()
    rows = logits.shape[-1]
    m = comm.all_reduce_max(logits.detach().amax(-1).contiguous(), ms.group)
    sumexp = reduce_from_model(torch.exp(logits - m[..., None]).sum(-1))
    lse = m + torch.log(sumexp)
    at = gold_ids - start
    inside = (at >= 0) & (at < rows)
    mine = torch.gather(logits, -1, at.clamp(0, rows - 1)[..., None])[..., 0]
    return lse, reduce_from_model(torch.where(inside, mine, 0.0))


__all__ = ["attn_splits", "copy_to_model", "embed_lookup", "gather_from_model", "join_heads",
           "join_vocab", "kv_heads", "local", "lse_and_gold", "own_part", "own_range",
           "query_heads", "reduce_from_model", "splits", "vocab_logits"]
