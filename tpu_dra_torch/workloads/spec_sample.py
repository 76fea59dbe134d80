"""Speculative sampling: the rejection-scheme commit for temperature > 0,
ported from ``tpu_dra/workloads/spec_sample.py``.

A draft token ``d_j`` drawn from the draft distribution ``q_j`` is
accepted with probability ``min(1, p_j(d_j) / q_j(d_j))`` against the
target distribution ``p_j``; the first rejection resamples from the
residual ``norm(max(p_j - q_j, 0))`` and ends the chunk; a chunk accepted
whole appends a bonus token drawn from the target's next position.  The
committed stream is then distributed exactly as target-only sampling,
for any draft.

Where the reference splits a PRNG key per slot, the port takes the
pass's random draws as tensors: ``uniforms`` for the accept tests and
Gumbel noise for the resample and the bonus (a categorical draw is
``argmax(log p + gumbel)``, as ``jax.random.categorical`` computes it).
The engine draws them from each request's own ``torch.Generator``; the
tests feed the reference's own draws.
"""

from __future__ import annotations

import torch


def commit_sampled(token, pos, eos, done, drafts, t_logits, q_logits,
                   uniforms, g_resample, g_bonus):
    """One speculative-sampling accept/commit for every slot — the
    sampled twin of :func:`commit_greedy` (same outputs).

    Both logit sets arrive FINAL: temperature-scaled and top-k/top-p
    filtered exactly as the proposals were drawn (the rejection math is
    exact only when q as scored equals q as sampled).

    Args:
      token:      [slots] int32 last committed token (held when frozen).
      pos:        [slots] int32 committed positions.
      eos:        [slots] int32 eos id (-1 = none).
      done:       [slots] bool frozen slots (hold, commit 0).
      drafts:     [slots, k-1] int32 draft-sampled tokens.
      t_logits:   [slots, k, V] final target logits (position j = the
        distribution of the token after j committed chunk tokens).
      q_logits:   [slots, k-1, V] final draft logits of the drafted
        positions.
      uniforms:   [slots, k-1] U[0, 1) draws of the accept tests.
      g_resample: [slots, V] Gumbel noise of the resample.
      g_bonus:    [slots, V] Gumbel noise of the bonus draw.

    Returns ``(token2, pos2, done2, emit [slots, k], counts)``: counts =
    accepted + 1 (resample or bonus), 0 for frozen slots; emit rows carry
    the committed tokens left-aligned, 0 past count.
    """
    slots, k, V = t_logits.shape
    p = torch.softmax(t_logits.float(), dim=-1)
    q = torch.softmax(q_logits.float(), dim=-1)
    d = drafts.long()[..., None]
    draft_p = p[:, :k - 1].gather(-1, d)[..., 0]            # p_j(d_j)
    draft_q = q.gather(-1, d)[..., 0]                       # q_j(d_j)
    ratio = draft_p / torch.clamp(draft_q, min=1e-20)
    accept = uniforms < torch.clamp(ratio, max=1.0)         # [slots, k-1]
    n = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)

    # rejection at position n: resample from norm(max(p_n - q_n, 0)).  A
    # row accepted whole has no rejection; its clamped index is junk the
    # final where() routes around.  A degenerate residual (p == q and
    # still rejected, numerically possible) falls back to p_n itself.
    idx = torch.clamp(n, max=k - 2).long()[:, None, None].expand(
        slots, 1, V)
    p_rej = p.gather(1, idx)[:, 0]
    q_rej = q.gather(1, idx)[:, 0]
    resid = torch.clamp(p_rej - q_rej, min=0.0)
    mass = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(mass > 1e-12, resid / torch.clamp(mass, min=1e-20),
                        p_rej)
    resampled = torch.argmax(g_resample + torch.log(resid + 1e-30), dim=-1)
    # a row accepted whole draws its bonus from the target's k-th position
    bonus = torch.argmax(g_bonus + torch.log(p[:, k - 1] + 1e-30), dim=-1)

    final = torch.where(n == k - 1, bonus, resampled).to(torch.int32)
    return commit_tail(token, pos, eos, done, drafts, n, final)


def commit_greedy(token, pos, eos, done, drafts, preds):
    """The greedy accept/commit for every slot: the longest prefix of
    ``drafts`` [slots, k-1] equal to the target's argmax ``preds``
    [slots, k] (position j predicts the token after j chunk tokens), then
    the target's own next token.  Same arguments (``preds`` for the
    logits) and outputs as :func:`commit_sampled`."""
    match = (drafts == preds[:, :-1]).to(torch.int32)
    n = torch.cumprod(match, dim=1).sum(dim=1)
    final = preds.gather(1, n[:, None].long())[:, 0].to(torch.int32)
    return commit_tail(token, pos, eos, done, drafts, n, final)


def commit_tail(token, pos, eos, done, drafts, n, final):
    """The commit both rules share, from the accepted count ``n`` [slots]
    and the token that follows the accepted drafts ``final`` [slots]:
    emit ``d_1 .. d_n, final``; frozen slots hold and commit 0; an eos
    anywhere in the committed prefix freezes the slot (the host trims
    the emitted tokens at eos)."""
    k = drafts.shape[1] + 1
    j = torch.arange(k, device=drafts.device)[None, :]
    padded = torch.cat([drafts.to(torch.int32),
                        torch.zeros_like(drafts[:, :1], dtype=torch.int32)],
                       dim=1)
    nn = n[:, None]
    emit = torch.where(j < nn, padded,
                       torch.where(j == nn, final[:, None],
                                   torch.zeros_like(padded)))
    counts = torch.where(done, torch.zeros_like(n), n + 1).to(torch.int32)
    live = j < counts[:, None]
    hit = (live & (emit == eos[:, None]) & (eos >= 0)[:, None]).any(dim=1)
    return (torch.where(done, token, final), pos + counts, done | hit, emit,
            counts)
