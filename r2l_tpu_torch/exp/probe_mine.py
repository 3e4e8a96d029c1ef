"""The parts of a distillation step outside the kernels, each alone: hard
sampling, the top-k, the pool update, Adam.

Port of ``exp/probe_mine.py:69-180``. Each piece runs K = 200 times back to
back, each iteration fed the previous one's output (so none can be left
out), then a checksum of the first column of what it carries; one warm-up
call, then the fastest of 3 timed with CUDA events, as ms per iteration
(records ``r3_mine_<piece>``):

* ``sample_perm``: the first 16,384 of a permutation of the 1,638,400-ray
  pool (``randperm``), gathered;
* ``sample_strat``: one slot drawn from each of 16,384 equal strata,
  gathered;
* ``sample_randint``: 16,384 slots drawn with replacement (a lower bound,
  not the reference's semantics), gathered;
* ``topk_exact``: ``torch.topk`` of the 65,536 fresh rays' losses, 8,192
  kept (one loss rewritten each time, as a dependence);
* ``update_pool``: ``hardmine.update_pool`` of a full pool with 8,192 hard
  rays at fixed slots;
* ``adam``: an Adam update of the canonical W256/D88 student's parameters
  (``train.make_optimizer``, lr 5e-4) with every gradient 1e-6.

The draws come from one generator on the card. Not ported: ``topk_approx``
(``jax.lax.approx_max_k``, a TPU operation with no PyTorch counterpart;
ROADMAP's "Do not port").

    python -m r2l_tpu_torch.exp.probe_mine [--out PATH]

(on a GPU; the JSON records go to stdout and, with ``--out``, to PATH.)
"""
from __future__ import annotations

import torch

from ..hardmine import HardPool, update_pool
from ..models.r2l import R2LConfig, init_r2l
from ..train import make_optimizer
from . import _harness, _train

B = _train.B
N_OUT, N_IN = _train.N_HARD_OUT, _train.N_HARD_IN
CAP = B * 20            # the pool at hard_mul 20
K = 200                 # chained iterations per call
REPS = 3
LR = 5e-4
RAYS_SEED, LOSS_SEED, HARD_SEED, ADAM_SEED = 0, 2, 3, 5
SAMPLERS = ("sample_perm", "sample_strat", "sample_randint")


def draw(name: str, g: torch.Generator, cap: int = CAP,
         n: int = N_OUT) -> torch.Tensor:
    """A sampler's n pool slots [n] int64, drawn from ``g``."""
    dev = g.device
    if name == "sample_perm":
        return torch.randperm(cap, generator=g, device=dev)[:n]
    if name == "sample_strat":
        stride = cap // n
        off = torch.randint(0, stride, (n,), generator=g, device=dev)
        return torch.arange(n, device=dev) * stride + off
    if name == "sample_randint":
        return torch.randint(0, cap, (n,), generator=g, device=dev)
    raise ValueError(f"unknown sampler {name!r}")


def pick(rays: torch.Tensor, acc: torch.Tensor, idx: torch.Tensor
         ) -> torch.Tensor:
    """A sampling iteration: gather the slots, add their first column's sum
    to ``acc`` [1]."""
    return acc + rays[idx][:, :1].sum()


def topk(pr: torch.Tensor, acc: torch.Tensor, n_fresh: int = B - N_OUT,
         n_in: int = N_IN) -> torch.Tensor:
    """A top-k iteration: the n_in largest of the fresh losses, the first
    index added to ``acc``; ``pr[0]`` rewritten from ``acc`` (in place)."""
    ids = torch.topk(pr[:n_fresh], n_in).indices
    pr[0] = acc[0] * 1e-9
    return acc + ids[:1].to(torch.float32).sum()


def full_pool(rays: torch.Tensor) -> HardPool:
    """A pool full of ``rays``, its pointer at 0."""
    dev = rays.device
    return HardPool(rays=rays.clone(), size=torch.tensor(
        rays.shape[0], dtype=torch.int32, device=dev),
        ptr=torch.zeros((), dtype=torch.int32, device=dev))


def fixed_slots(cap: int = CAP, n: int = N_OUT, device="cpu"
                ) -> torch.Tensor:
    """The update's sampled slots: every (cap // n)-th."""
    return torch.arange(n, dtype=torch.int32, device=device) * (cap // n)


def adam(cfg: R2LConfig | None, device) -> tuple:
    """(model, optimizer, gradients): the canonical student from
    ``ADAM_SEED``, Adam at ``LR``, every gradient 1e-6."""
    model = init_r2l(cfg or R2LConfig(compute_dtype=torch.bfloat16),
                     torch.Generator().manual_seed(ADAM_SEED), device)
    grads = [torch.full_like(p, 1e-6) for p in model.parameters()]
    return model, make_optimizer(model.parameters(), LR), grads


def adam_step(model, opt, grads) -> None:
    for p, g in zip(model.parameters(), grads):
        p.grad = g
    opt.step()


def pieces(device, gen: torch.Generator) -> dict:
    """piece -> (a call of ``k`` chained iterations -> checksum)."""
    rays = _train.uniform((CAP, 9), torch.Generator().manual_seed(
        RAYS_SEED), device)
    per_ray = _train.uniform((B,), torch.Generator().manual_seed(LOSS_SEED),
                             device)
    hard = _train.uniform((N_IN, 9), torch.Generator().manual_seed(
        HARD_SEED), device)
    slots = fixed_slots(CAP, N_OUT, device)
    pool = full_pool(rays)
    model, opt, grads = adam(None, device)
    zero = torch.zeros((1,), device=device)

    def sampler(name):
        def run(k):
            acc = zero
            for _ in range(k):
                acc = pick(rays, acc, draw(name, gen, CAP, N_OUT))
            return acc.sum()
        return run

    def run_topk(k):
        pr, acc = per_ray.clone(), zero
        for _ in range(k):
            acc = topk(pr, acc, B - N_OUT, N_IN)
        return acc.sum() + pr[:1].sum()

    def run_update(k):
        p = pool
        for i in range(k):
            p = update_pool(p, hard + i * 1e-9, slots)
        return p.rays[:1].sum()

    def run_adam(k):
        for _ in range(k):
            adam_step(model, opt, grads)
        return model.linears()[2].bias.detach().sum()

    return {**{n: sampler(n) for n in SAMPLERS}, "topk_exact": run_topk,
            "update_pool": run_update, "adam": run_adam}


def main(argv=None) -> list[dict]:
    args = _harness.parse(argv, "python -m r2l_tpu_torch.exp.probe_mine",
                          __doc__)
    dev = _harness.require_cuda(args.prog)
    log = _harness.Log(args.out)
    recs = [log({**_harness.device_record(),
                 "protocol": f"{K} chained iterations a call, CUDA "
                             "events"})]
    fns = pieces(dev, torch.Generator(dev).manual_seed(0))
    for name, run in fns.items():
        recs.append(_harness.timed(f"r3_mine_{name}",
                                   lambda r=run: r(K), REPS, K, log,
                                   unit="ms_per_iter"))
    recs.append(log({"name": "done"}))
    return recs


if __name__ == "__main__":
    main()
