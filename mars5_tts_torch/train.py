"""Training: AR next-token cross-entropy and the NAR multinomial-diffusion
variational bound (counterpart of ``mars5_tts_tpu/train.py``).

* ``ar_loss_fn``: teacher-forced next-token CE over the joint text + speech
  sequence with an ignore mask, ``sum(nll * mask) / sum(mask)`` over the
  whole batch.
* ``nar_loss_fn``: t ~ U[0, T), x_t ~ q(x_t | x_0), x0 logits under
  train-time CFG conditioning dropout, and the VB term
  (``MultinomialDiffusion.compute_Lt``) a row, averaged and divided by the
  frames x codebooks. Its draws (``NarDraws``: t, the Gumbel uniforms and
  the drop flags) come from an explicit generator at the global batch
  shape, or are given (the tests inject the JAX package's).
* ``make_optimizer``: optax's ``adamw`` (weight decay on every parameter),
  optional ``clip_by_global_norm`` ahead of it, the warmup-cosine schedule
  (to 10% of peak) read at the inner update count, and ``MultiSteps``
  accumulation (the Welford mean of k gradients applied every k calls,
  the parameters untouched in between), with optax's arithmetic.
* ``TrainState`` / ``make_train_step``: the AR and the NAR, an optimizer
  state each, the step count and the generator; one call runs an AR step
  and a NAR step and returns ``{"ar_loss", "nar_loss"}``.
* ``shard_train_state``: the parameters placed on a (dp, tp) mesh
  (``parallel/``), the Adam moments following them. The step then carries
  the batch as DTensors sharded on ``dp``, so every reduction is over the
  global batch, as under XLA SPMD.
* ``save_train_checkpoint`` / ``restore_train_checkpoint``: ``torch.save``
  of the parameters, both optimizer states (moments, counts, accumulation
  buffers), the step and the generator state.

Kernel K1 has no backward (``ops/kernels/mha.refuse_autograd``): on the card
a training batch keeps NAR frames and speaker references under 512 rows.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from .diffusion.multinomial import MultinomialDiffusion, index_to_log_onehot
from .utils.device import is_dtensor


def ar_loss_fn(model: nn.Module, tokens, loss_mask, spk_codes):
    """Next-token CE. tokens (bs, L); loss_mask (bs, L-1), 1 where the target
    at position i + 1 counts; spk_codes (bs, S, 8)."""
    logits = model(tokens[:, :-1], spk_codes=spk_codes).float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, tokens[:, 1:, None])[..., 0]
    mask = loss_mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


@dataclass
class NarDraws:
    """The NAR loss's randomness: t (bs,) int64, u (bs, L, 8, K) f32 uniforms
    of the Gumbel draw of x_t, drop (bs,) bool conditioning dropout."""
    t: torch.Tensor
    u: torch.Tensor
    drop: torch.Tensor


def nar_draws(diff: MultinomialDiffusion, x0_shape, generator: torch.Generator,
              p_cond_drop: float = 0.1) -> NarDraws:
    """Draws at the global batch shape ``x0_shape`` (bs, L, 8) from
    ``generator``, on its device: a sharded step sees the single-process
    step's draws."""
    dev = generator.device
    bs = x0_shape[0]
    t = torch.randint(0, diff.num_timesteps, (bs,), generator=generator, device=dev)
    u = torch.rand((*x0_shape, diff.num_classes), generator=generator, device=dev)
    drop = torch.rand((bs,), generator=generator, device=dev) < p_cond_drop
    return NarDraws(t, u, drop)


def nar_loss_fn(model: nn.Module, diff: MultinomialDiffusion, batch, draws: NarDraws):
    """Multinomial-diffusion VB on a clean batch (c_text, c_codes,
    c_texts_length, c_codes_length, x0 (bs, L, 8), x_padding_mask); padded
    frames are masked in attention and count in the normalisation, as in
    the JAX package."""
    c_text, c_codes, ctl, ccl, x0, xpm = batch
    k = diff.num_classes
    log_x0 = index_to_log_onehot(x0, k)
    x_t = diff.q_sample(log_x0, draws.t, draws.u)
    logits = model(c_text, c_codes, ctl, ccl, x_t, xpm, draws.t, drop_cond=draws.drop).float()
    log_pred = torch.log_softmax(logits, dim=-1)
    vb = diff.compute_Lt(log_x0, index_to_log_onehot(x_t, k), log_pred, draws.t)
    return vb.mean() / (x0.shape[1] * x0.shape[2])


# --- the optimizer ------------------------------------------------------------

@dataclass
class OptState:
    """One model's optimizer state: Adam's moments (name -> tensor, placed
    as their parameter), its update count, the schedule's count, and the
    accumulation's mini-step, applied-step count and mean gradient."""
    mu: dict
    nu: dict
    count: int = 0
    sched_count: int = 0
    mini_step: int = 0
    gradient_step: int = 0
    acc: dict = field(default_factory=dict)


def _full(t):
    """A DTensor's global value (a collective over its mesh), else ``t``. A
    strided row shard (the NAR's in-projections, ``parallel.sharding``) is
    gathered as the plain row shard of the same local rows and its rows put
    back in order: some PyTorch versions cannot redistribute a strided
    shard."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    strided = [i for i, p in enumerate(t.placements) if isinstance(p, _StridedShard)]
    if not strided:
        return t.full_tensor()
    (i,) = strided
    sf, n = t.placements[i].split_factor, t.device_mesh.size(i)
    if t.placements[i].dim != 0:
        raise ValueError("only a strided shard of rows is gathered")
    rows = tuple(Shard(0) if j == i else p for j, p in enumerate(t.placements))
    whole = DTensor.from_local(t.to_local(), t.device_mesh, rows, run_check=False).full_tensor()
    # rows (device, part, row) -> (part, device, row)
    parts = whole.view(n, sf, whole.shape[0] // (n * sf), *whole.shape[1:])
    return parts.transpose(0, 1).reshape(whole.shape)


@dataclass(frozen=True)
class Optimizer:
    """AdamW with optional global-norm clipping, warmup-cosine schedule and
    gradient accumulation: ``make_optimizer``'s optax chain, with its
    arithmetic (f32 throughout)."""
    lr: float = 1e-4
    weight_decay: float = 0.01
    warmup_steps: int = 0
    total_steps: int = 0
    clip_norm: float = 0.0
    accum_steps: int = 1
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def schedule(self, count: int) -> np.float32:
        """The learning rate at inner update ``count``: optax's
        ``warmup_cosine_decay_schedule(0, lr, max(warmup, 1), total, 0.1 lr)``
        when ``total_steps > 0``, else the constant ``lr``."""
        f32, lr = np.float32, np.float32(self.lr)
        if self.total_steps <= 0:
            return lr
        warm = max(self.warmup_steps, 1)
        if count < warm:
            frac = f32(1) - f32(min(max(count, 0), warm)) / f32(warm)
            return (f32(0) - lr) * frac + lr
        decay = float(self.total_steps - warm)
        c = f32(min(float(count - warm), decay))
        alpha = 0.1 * self.lr / self.lr
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay)))
        return lr * (f32(1 - alpha) * cosine + f32(alpha))

    def init(self, params: dict) -> OptState:
        """Zero moments (and accumulators) placed as ``params``."""
        def zeros():
            return {n: torch.zeros_like(p) for n, p in params.items()}

        return OptState(mu=zeros(), nu=zeros(), acc=zeros() if self.accum_steps > 1 else {})

    @torch.no_grad()
    def apply(self, params: dict, grads: dict, state: OptState) -> None:
        """One call of the optax update followed by ``apply_updates``, in
        place: with accumulation, fold ``grads`` into the running mean and
        update the parameters only on every ``accum_steps``-th call. Each
        elementwise op runs over a chunk of the tensors at once
        (``torch._foreach_*``, the same arithmetic a tensor at a time)."""
        names = list(params)
        g = [grads[n].redistribute(params[n].device_mesh, params[n].placements)
             if is_dtensor(grads[n]) and grads[n].placements != params[n].placements
             else grads[n] for n in names]
        if self.accum_steps > 1:
            acc = [state.acc[n] for n in names]
            for ix in _chunks(acc):
                a = [acc[i] for i in ix]
                d = torch._foreach_sub([g[i] for i in ix], a)
                torch._foreach_div_(d, state.mini_step + 1)
                torch._foreach_add_(a, d)
            emit = state.mini_step == self.accum_steps - 1
            state.mini_step = (state.mini_step + 1) % self.accum_steps
            if not emit:
                return
            state.gradient_step += 1
            g = [a.clone() for a in acc]
            torch._foreach_zero_(acc)
        if self.clip_norm > 0:
            norms = [_full(x) for ix in _chunks(g) for x in torch._foreach_norm([g[i] for i in ix])]
            g_norm = torch.sqrt(torch.stack(norms).square().sum())
            if not bool(g_norm < self.clip_norm):
                for ix in _chunks(g):
                    gc = [g[i] for i in ix]
                    torch._foreach_div_(gc, g_norm)
                    torch._foreach_mul_(gc, self.clip_norm)
        state.count += 1
        dev = g[0].device
        bc1 = (1 - torch.tensor(self.b1, dtype=torch.float32) ** float(state.count)).to(dev)
        bc2 = (1 - torch.tensor(self.b2, dtype=torch.float32) ** float(state.count)).to(dev)
        step = float(-self.schedule(state.sched_count))
        state.sched_count += 1
        for ix in _chunks(g):
            p = [params[names[i]] for i in ix]
            gc = [g[i] for i in ix]
            mu = [state.mu[names[i]] for i in ix]
            nu = [state.nu[names[i]] for i in ix]
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, torch._foreach_mul(gc, 1 - self.b1))
            torch._foreach_mul_(nu, self.b2)
            sq = torch._foreach_mul(gc, gc)
            torch._foreach_mul_(sq, 1 - self.b2)
            torch._foreach_add_(nu, sq)
            u = torch._foreach_div(mu, bc1)
            v = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(v)
            torch._foreach_add_(v, self.eps)
            torch._foreach_div_(u, v)
            torch._foreach_add_(u, torch._foreach_mul(p, self.weight_decay))
            torch._foreach_mul_(u, step)
            torch._foreach_add_(p, u)


CHUNK_ELEMENTS = 1 << 26        # about 256 MB of f32 a chunk of the optimizer's passes


def _chunks(tensors):
    """Index lists of consecutive tensors of at most ``CHUNK_ELEMENTS`` in
    all (or one tensor), bounding the temporaries of a foreach pass."""
    out, cur, n = [], [], 0
    for i, t in enumerate(tensors):
        if cur and n + t.numel() > CHUNK_ELEMENTS:
            out.append(cur)
            cur, n = [], 0
        cur.append(i)
        n += t.numel()
    return out + [cur] if cur else out


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.01, warmup_steps: int = 0,
                   total_steps: int = 0, clip_norm: float = 0.0,
                   accum_steps: int = 1) -> Optimizer:
    """AdamW at ``lr`` with weight decay; ``clip_norm > 0`` clips the global
    gradient norm; ``total_steps > 0`` runs the warmup-cosine schedule (to
    10% of peak, the first applied update at warmup lr 0); ``accum_steps >
    1`` applies the mean gradient every ``accum_steps`` calls. The defaults
    are plain AdamW at a constant lr."""
    return Optimizer(lr=lr, weight_decay=weight_decay, warmup_steps=warmup_steps,
                     total_steps=total_steps, clip_norm=clip_norm, accum_steps=accum_steps)


# --- the train state and step -------------------------------------------------

def trainable_params(model: nn.Module) -> dict:
    """{name: parameter} of the parameters that train."""
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


@dataclass
class TrainState:
    """The AR and NAR modules (their parameters trained in place), an
    optimizer state each, the step count, the generator of the NAR draws,
    and the mesh once ``shard_train_state`` has placed them."""
    ar: nn.Module
    ar_opt: OptState
    nar: nn.Module
    nar_opt: OptState
    step: int
    generator: torch.Generator
    mesh: object = None


def init_train_state(ar: nn.Module, nar: nn.Module, optimizer: Optimizer,
                     generator: torch.Generator | None = None, seed: int = 0) -> TrainState:
    """A state at step 0 over trainable modules; the generator defaults to
    one on the AR's device seeded with ``seed``."""
    if generator is None:
        generator = torch.Generator(device=ar.embed.weight.device).manual_seed(seed)
    return TrainState(ar=ar, ar_opt=optimizer.init(trainable_params(ar)), nar=nar,
                      nar_opt=optimizer.init(trainable_params(nar)), step=0,
                      generator=generator)


AR_DTYPES = (torch.long, torch.float32, torch.long)
NAR_DTYPES = (torch.long, torch.long, torch.long, torch.long, torch.long, torch.bool)


def to_batch(batch, dtypes, device, mesh=None) -> tuple:
    """A numpy batch of ``data.py`` as tensors of ``dtypes`` (``AR_DTYPES``,
    ``NAR_DTYPES``) on ``device``; with a mesh, DTensors sharded on ``dp``
    (rows) and replicated on ``tp``."""
    out = []
    for x, dt in zip(batch, dtypes):
        t = torch.as_tensor(np.asarray(x)).to(device=device, dtype=dt)
        out.append(t if mesh is None else _on_dp(mesh, t))
    return tuple(out)


def _on_dp(mesh, t):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    return distribute_tensor(t, mesh, (Shard(0), Replicate()), src_data_rank=None)


def _spmd(mesh):
    """Plain tensors count as replicated beside DTensors (a sharded step)."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _sync(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def make_train_step(diff: MultinomialDiffusion, optimizer: Optimizer,
                    p_cond_drop: float = 0.1, timed: bool = False):
    """The combined (AR + NAR) step: ``train_step(state, ar_batch, nar_batch,
    draws=None) -> (state, {"ar_loss", "nar_loss"})``, advancing ``state`` in
    place. Batches are ``data.py``'s numpy tuples (or tensors); ``draws``
    default to ``nar_draws`` from the state's generator. ``timed``: the
    metrics also hold ``ar_s`` and ``nar_s``, each half's wall seconds with
    the device synchronised at its ends."""

    def update(model, opt_state, loss_fn):
        params = trainable_params(model)
        loss = loss_fn()
        grads = torch.autograd.grad(loss, list(params.values()))
        optimizer.apply(params, dict(zip(params, grads)), opt_state)
        return _full(loss.detach())

    def train_step(state: TrainState, ar_batch, nar_batch, draws: NarDraws | None = None):
        mesh = state.mesh
        dev = state.generator.device
        t0 = _sync(dev) if timed else 0.0
        ar_b = to_batch(ar_batch, AR_DTYPES, dev, mesh)
        with _spmd(mesh):
            ar_l = update(state.ar, state.ar_opt, lambda: ar_loss_fn(state.ar, *ar_b))
        t1 = _sync(dev) if timed else 0.0
        nar_b = to_batch(nar_batch, NAR_DTYPES, dev, mesh)
        if draws is None:
            draws = nar_draws(diff, tuple(np.shape(nar_batch[4])), state.generator, p_cond_drop)
        if mesh is not None:
            draws = NarDraws(*(_on_dp(mesh, x) for x in (draws.t, draws.u, draws.drop)))
        with _spmd(mesh):
            nar_l = update(state.nar, state.nar_opt,
                           lambda: nar_loss_fn(state.nar, diff, nar_b, draws))
        state.step += 1
        metrics = {"ar_loss": ar_l, "nar_loss": nar_l}
        if timed:
            metrics.update(ar_s=t1 - t0, nar_s=_sync(dev) - t1)
        return state, metrics

    return train_step


def shard_train_state(mesh, state: TrainState, ar_specs: dict, nar_specs: dict) -> TrainState:
    """Place the parameters on a (dp, tp) mesh by their specs
    (``parallel.codeclm_specs`` / ``nar_specs``) and every optimizer tensor
    on its parameter's placement, in place; later steps take the batch
    sharded on ``dp``. Returns ``state``."""
    from torch.distributed.tensor import distribute_tensor

    from .parallel import shard_tree

    for model, opt, specs in ((state.ar, state.ar_opt, ar_specs),
                              (state.nar, state.nar_opt, nar_specs)):
        shard_tree(mesh, model, specs)
        params = trainable_params(model)
        for tree in (opt.mu, opt.nu, opt.acc):
            for n in tree:
                p = params[n]
                tree[n] = distribute_tensor(tree[n], mesh, p.placements)
    state.mesh = mesh
    return state


# --- checkpoints --------------------------------------------------------------

def _full_tree(tree: dict) -> dict:
    return {n: _full(t.detach()).cpu() for n, t in tree.items()}


def _opt_payload(opt: OptState) -> dict:
    return {"mu": _full_tree(opt.mu), "nu": _full_tree(opt.nu), "acc": _full_tree(opt.acc),
            "count": opt.count, "sched_count": opt.sched_count,
            "mini_step": opt.mini_step, "gradient_step": opt.gradient_step}


def save_train_checkpoint(path, state: TrainState) -> None:
    """Write the whole training state (parameters, both optimizer states,
    step, generator) with ``torch.save``; sharded tensors are gathered, and
    only rank 0 writes when ``torch.distributed`` runs."""
    import torch.distributed as dist

    payload = {"ar": _full_tree(dict(state.ar.named_parameters())),
               "nar": _full_tree(dict(state.nar.named_parameters())),
               "ar_opt": _opt_payload(state.ar_opt), "nar_opt": _opt_payload(state.nar_opt),
               "step": state.step, "generator": state.generator.get_state()}
    distributed = dist.is_available() and dist.is_initialized()
    if not distributed or dist.get_rank() == 0:
        torch.save(payload, str(path))
    if distributed:
        dist.barrier()


@torch.no_grad()
def restore_train_checkpoint(path, state_like: TrainState) -> TrainState:
    """Load a ``save_train_checkpoint`` file into ``state_like`` (an
    unsharded state of the same models and optimizer, e.g. a fresh
    ``init_train_state``), in place; re-shard with ``shard_train_state``
    afterwards for mesh runs. Returns ``state_like``."""
    ck = torch.load(str(path), map_location="cpu", weights_only=False)
    for model, key in ((state_like.ar, "ar"), (state_like.nar, "nar")):
        for n, p in model.named_parameters():
            p.copy_(ck[key][n])
    for opt, key in ((state_like.ar_opt, "ar_opt"), (state_like.nar_opt, "nar_opt")):
        saved = ck[key]
        for name in ("mu", "nu", "acc"):
            tree = getattr(opt, name)
            for n in tree:
                tree[n].copy_(saved[name][n])
        for name in ("count", "sched_count", "mini_step", "gradient_step"):
            setattr(opt, name, saved[name])
    state_like.step = ck["step"]
    state_like.generator.set_state(ck["generator"])
    return state_like
