"""Training loop for the pitch-recognition model.

Port of ``pitchvis_tpu/train/train.py`` (the optax/flax port of
pitchvis_train/train.py:108-208): BCE loss, Adam (lr=1e-5, betas
0.9/0.999, eps=1.1920929e-7) with additive weight decay 5e-4 (torch Adam's
decay, added to the gradient before the moment update), batch 300, 32
epochs, 80/20 random split, micro-F1 + accuracy eval. Checkpoints are NumPy
files (``model_<time_ns>.npz`` beside ``train_meta.json``), not orbax.

The split and the shuffles draw from ``np.random.default_rng(cfg.seed)``
with the JAX trainer's calls in its order, so both trainers see the same
batches in the same order. The model starts from
``PitchMLP(seed=cfg.seed)``'s flax-style initialisation (the same
distribution as the JAX trainer's, not the same numbers: JAX's keys are not
torch's generator), and dropout masks come from a ``torch.Generator``
seeded with ``cfg.seed`` on the training device.

Data layout matches the reference's data.npy: flat f32 rows of (n_buckets
VQT dB values + 128 MIDI targets); windows of T consecutive frames are the
model input (train.py:17-46). Runs on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time

import numpy as np
import torch

from ..core.device import resolve_device
from ..models.pitch_mlp import N_MIDI, PitchMLP


@dataclasses.dataclass
class TrainConfig:
    n_buckets: int = 7 * 36
    t_window: int = 5
    mlp_size: int = 1024
    mlp_layers: int = 2
    dropout: float = 0.1
    epochs: int = 32
    batch_size: int = 300
    learning_rate: float = 1e-5
    weight_decay: float = 5e-4
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1.1920929e-7
    train_fraction: float = 0.8
    seed: int = 0
    # --- tuned-mode knobs (defaults reproduce the reference exactly) ---
    # schedule: "const" = reference (fixed lr, additive torch-Adam decay);
    # "warmup_cosine" = linear warmup then cosine decay with DECOUPLED
    # weight decay (AdamW)
    schedule: str = "const"
    warmup_frac: float = 0.05
    steps_hint: int = 0  # total steps for the schedule; set by train()


def tuned_config(**overrides) -> TrainConfig:
    """The better-than-reference recipe: same model, data, split and eval;
    AdamW, lr 3e-4, 5% linear warmup, cosine decay, batch 1024. The
    reference's hyperparameters remain the default."""
    base = dict(
        learning_rate=3e-4,
        batch_size=1024,
        eps=1e-8,
        schedule="warmup_cosine",
    )
    base.update(overrides)
    return TrainConfig(**base)


def window_data(flat: np.ndarray, cfg: TrainConfig) -> tuple[np.ndarray, np.ndarray]:
    """Reshapes the flat data rows and windows T consecutive VQT frames
    (train.py:17-34): inputs (N-T+1, T*n_buckets), targets at the window's
    last frame."""
    row = cfg.n_buckets + N_MIDI
    data = flat.reshape(-1, row)
    vqt = data[:, : cfg.n_buckets]
    midi = data[:, cfg.n_buckets :]
    t = cfg.t_window
    n = vqt.shape[0] - t + 1
    if n <= 0:
        raise ValueError("not enough frames for one window")
    idx = np.arange(t)[None, :] + np.arange(n)[:, None]
    x = vqt[idx].reshape(n, t * cfg.n_buckets)
    y = midi[t - 1 :]
    return x.astype(np.float32), y.astype(np.float32)


def make_model(cfg: TrainConfig, device="cuda") -> PitchMLP:
    return PitchMLP(
        input_bins=cfg.t_window * cfg.n_buckets,
        mlp_size=cfg.mlp_size,
        mlp_layers=cfg.mlp_layers,
        dropout=cfg.dropout,
        seed=cfg.seed,
        device=device,
    )


def lr_schedule(cfg: TrainConfig):
    """Step count -> learning rate: constant, or for ``"warmup_cosine"``
    optax's warmup_cosine_decay_schedule(0, peak, warmup, decay_steps=total)
    (linear from 0 over the warmup, then a cosine to 0 at ``total``)."""
    peak = cfg.learning_rate
    if cfg.schedule != "warmup_cosine":
        return lambda count: peak
    total = max(cfg.steps_hint, 1)
    warmup = max(int(total * cfg.warmup_frac), 1)
    decay = total - warmup
    if not decay > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got decay_steps={decay}.")

    def schedule(count: int) -> float:
        if count < warmup:
            return peak * count / warmup
        t = min(count - warmup, decay)
        return peak * 0.5 * (1.0 + math.cos(math.pi * t / decay))

    return schedule


def make_optimizer(cfg: TrainConfig, model: PitchMLP):
    """(optimizer, scheduler) for ``model``'s parameters. ``"const"`` is
    optax's add_decayed_weights -> scale_by_adam -> scale(-lr): torch Adam,
    whose weight_decay is added to the gradient before the moments.
    ``"warmup_cosine"`` is scale_by_adam -> add_decayed_weights ->
    scale_by_learning_rate(schedule): AdamW (decoupled decay, scaled by the
    live lr) under a LambdaLR of lr_schedule; step the scheduler after the
    optimizer, so that update k runs at schedule(k), the first at 0."""
    params = model.parameters()
    betas = (cfg.beta1, cfg.beta2)
    if cfg.schedule == "warmup_cosine":
        opt = torch.optim.AdamW(params, lr=cfg.learning_rate, betas=betas, eps=cfg.eps,
                                weight_decay=cfg.weight_decay)
    else:
        opt = torch.optim.Adam(params, lr=cfg.learning_rate, betas=betas, eps=cfg.eps,
                               weight_decay=cfg.weight_decay)
    schedule = lr_schedule(cfg)
    peak = cfg.learning_rate
    scheduler = torch.optim.lr_scheduler.LambdaLR(opt, lambda count: schedule(count) / peak)
    return opt, scheduler


def bce_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on probabilities, the prediction clamped to
    [1e-7, 1 - 1e-7] before the log (the JAX trainer's formula; nn.BCELoss
    clamps the log at -100 instead)."""
    eps = 1e-7
    p = pred.clamp(eps, 1.0 - eps)
    return -torch.mean(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))


def train_step(model: PitchMLP, optimizer, x: torch.Tensor, y: torch.Tensor, scheduler=None,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """One update on the batch (x, y): forward with dropout (masks from
    ``generator``), BCE, backward, the optimizer's step and then the
    scheduler's. Returns the batch loss, a 0-dim tensor on the device (read
    it when needed: converting it waits for the card)."""
    optimizer.zero_grad(set_to_none=True)
    loss = bce_loss(model(x, train=True, generator=generator), y)
    loss.backward()
    optimizer.step()
    if scheduler is not None:
        scheduler.step()
    return loss.detach()


@torch.no_grad()
def eval_step(model: PitchMLP, x: torch.Tensor, y: torch.Tensor):
    """(tp, fp, fn, correct) as 0-dim tensors on the device, and the number
    of predictions, at the 0.5 threshold."""
    predicted = model(x) > 0.5
    labels = y > 0.5
    tp = torch.sum(predicted & labels)
    fp = torch.sum(predicted & ~labels)
    fn = torch.sum(~predicted & labels)
    correct = torch.sum(predicted == labels)
    return tp, fp, fn, correct, predicted.numel()


def train(
    data: np.ndarray,
    cfg: TrainConfig | None = None,
    *,
    checkpoint_dir: str | None = None,
    log_every: int = 50,
    epochs: int | None = None,
    device="cuda",
):
    """Trains on a flat data array (the data.npy layout). Returns (params,
    metrics dict); params is the trained model's state_dict on ``device``
    (the ``ml_params`` of StreamingPipeline and StreamServer). The windows go to the device once; each
    epoch sends its shuffled indices and reads its losses back once."""
    device = resolve_device(device)
    cfg = cfg or TrainConfig()
    if epochs is not None:
        cfg = dataclasses.replace(cfg, epochs=epochs)
    x, y = window_data(np.asarray(data, np.float32), cfg)

    rng = np.random.default_rng(cfg.seed)
    perm = rng.permutation(len(x))
    n_train = int(len(x) * cfg.train_fraction)
    train_idx, test_idx = perm[:n_train], perm[n_train:]

    model = make_model(cfg, device=device)
    # the final partial batch trains too, like the reference's DataLoader
    # default (drop_last=False, pitchvis_train/train.py:108-116)
    per_epoch = -(-n_train // cfg.batch_size) if n_train else 0
    cfg = dataclasses.replace(cfg, steps_hint=cfg.epochs * per_epoch)
    optimizer, scheduler = make_optimizer(cfg, model)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    xt = torch.from_numpy(x).to(device)
    yt = torch.from_numpy(y).to(device)

    b = cfg.batch_size
    step = 0
    epoch_losses: list[float] = []
    model.train()
    for epoch in range(cfg.epochs):
        rng.shuffle(train_idx)
        order = torch.from_numpy(train_idx).to(device)
        losses = []
        for i in range(0, len(train_idx), b):
            batch = order[i : i + b]
            losses.append(train_step(model, optimizer, xt[batch], yt[batch], scheduler, gen))
            step += 1
        if losses:
            epoch_losses.append(float(torch.stack(losses).double().mean()))
            print(f"[epoch {epoch + 1}] loss: {epoch_losses[-1]:.4f}", flush=True)
    model.eval()

    # evaluation (micro-F1 + accuracy, train.py:164-198)
    counts = torch.zeros(4, dtype=torch.int64, device=device)
    total = 0
    order = torch.from_numpy(test_idx).to(device)
    for i in range(0, len(test_idx), b):
        batch = order[i : i + b]
        *r, size = eval_step(model, xt[batch], yt[batch])
        counts += torch.stack(r)
        total += size
    tp, fp, fn, correct = (int(v) for v in counts.cpu())
    f1 = 2 * tp / max(2 * tp + fp + fn, 1)
    acc = correct / max(total, 1)
    metrics = {"f1_micro": f1, "accuracy": acc, "steps": step, "epoch_loss": epoch_losses}
    print(f"micro-F1: {f1:.3f}, accuracy: {acc:.3%}")

    params = model.state_dict()
    if checkpoint_dir:
        save_checkpoint(checkpoint_dir, params, cfg, metrics)
    return params, metrics


def _checkpoint_names(path: str) -> list[str]:
    """``model_<stamp>.npz`` files under ``path``, oldest first. The stamps
    sort as numbers (second- and nanosecond-stamped names must not compare
    as strings); staging files (``-tmp``) and other names (``model_best``)
    are skipped."""
    names = []
    for d in os.listdir(path):
        stem = d[: -len(".npz")] if d.endswith(".npz") else ""
        if stem.startswith("model_") and stem.split("_", 1)[1].isdigit():
            names.append(d)
    return sorted(names, key=lambda d: int(d[: -len(".npz")].split("_", 1)[1]))


def save_checkpoint(path: str, params: dict, cfg: TrainConfig, metrics: dict) -> None:
    """Writes ``params`` (a state_dict) as ``model_<time_ns>.npz`` under
    ``path`` and the config and metrics as ``train_meta.json`` (the JAX
    trainer's keys). The arrays are written to ``<name>-tmp`` and renamed,
    so a crash mid-save leaves no half-written checkpoint under a loadable
    name; the nanosecond stamp keeps two saves within a second apart."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    name = os.path.join(path, f"model_{time.time_ns()}.npz")
    with open(name + "-tmp", "wb") as f:
        np.savez(f, **{k: v.detach().cpu().numpy() for k, v in params.items()})
    os.replace(name + "-tmp", name)
    with open(os.path.join(path, "train_meta.json"), "w") as f:
        json.dump({"config": dataclasses.asdict(cfg), "metrics": metrics}, f)


def load_checkpoint(path: str, cfg: TrainConfig, device="cuda") -> dict:
    """The newest checkpoint under ``path`` as a state_dict on ``device``,
    checked against ``make_model(cfg)``'s shapes."""
    names = _checkpoint_names(path)
    if not names:
        raise FileNotFoundError(
            f"no model_<step> checkpoint under {path!r} (training may have "
            "crashed before its first save; staging files end in -tmp "
            "and are skipped)"
        )
    model = make_model(cfg, device=device)
    with np.load(os.path.join(os.path.abspath(path), names[-1])) as z:
        model.load_state_dict({k: torch.from_numpy(z[k]) for k in z.files})
    return model.state_dict()
