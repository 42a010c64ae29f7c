"""The port's checkpoints (``sparch_tpu_torch.train.checkpoint``): a state
saved after two steps, restored into a fresh state of the same
configuration, takes the third step bit for bit as the uninterrupted run
does (the loss, every parameter and running statistic, Adam's moments and
the generator), with dropout 0.1 and uniform state inits drawing from the
generator; the metadata is written whole through a temporary file; the
layout is the JAX package's (``best_model/`` a directory beside
``meta.json``)."""
import json
import os

import numpy as np
import pytest
import torch

from sparch_tpu.train import checkpoint as jax_checkpoint
from sparch_tpu_torch.models import build_model
from sparch_tpu_torch.train import (
    checkpoint_exists,
    create_train_state,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
)

B, T, F, H, C = 6, 9, 20, 12, 5


def trainer(model_type, cell_impl, init_seed):
    model = build_model(model_type, (B, T, F), [H, H, C], dropout=0.1,
                        state_init="uniform", cell_impl=cell_impl,
                        generator=torch.Generator().manual_seed(init_seed))
    state = create_train_state(model, 1e-2, device="cpu", seed=init_seed + 7)
    return state, make_train_step(model)


def batch(seed):
    g = torch.Generator().manual_seed(seed)
    x = (torch.rand((B, T, F), generator=g) < 0.2).float()
    return x, torch.randint(0, C, (B,), generator=g)


def snapshot(state):
    return dict(
        model={k: v.clone() for k, v in state.model.state_dict().items()},
        moments=[(k, v.clone()) for st in state.optimizer.state.values()
                 for k, v in st.items()],
        generator=state.generator.get_state().clone(), step=state.step)


def assert_same(a, b):
    assert a["step"] == b["step"]
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    assert len(a["moments"]) == len(b["moments"])
    for (ka, va), (kb, vb) in zip(a["moments"], b["moments"]):
        assert ka == kb and torch.equal(va, vb), ka
    assert torch.equal(a["generator"], b["generator"])


@pytest.mark.parametrize("model_type,cell_impl", [
    ("RadLIF", "scan"), ("RadLIF", "auto"), ("LIF", "auto"), ("GRU", "scan"),
    ("GRU", "auto"), ("LiGRU", "auto"),
])
def test_resume_is_bit_for_bit(tmp_path, model_type, cell_impl):
    state, step = trainer(model_type, cell_impl, init_seed=0)
    for s in (1, 2):
        state, _ = step(state, *batch(s))
    state.set_lr(7e-3)
    ckdir = str(tmp_path / "checkpoints")
    save_checkpoint(ckdir, state, meta={"epoch": 2})
    state, met = step(state, *batch(3))
    want_loss, want = float(met["loss"]), snapshot(state)

    # a fresh state of the same configuration, other weights and seed
    fresh, fresh_step = trainer(model_type, cell_impl, init_seed=5)
    fresh, meta = restore_checkpoint(ckdir, fresh)
    assert meta == {"epoch": 2}
    assert fresh.step == 2 and fresh.lr == 7e-3
    assert all(not torch.is_tensor(st.get("step")) or st["step"].is_cpu
               for st in fresh.optimizer.state.values())
    fresh, met = fresh_step(fresh, *batch(3))
    assert float(met["loss"]) == want_loss
    assert_same(snapshot(fresh), want)


def test_layout_and_meta(tmp_path):
    state, _ = trainer("RadLIF", "scan", init_seed=0)
    ckdir = str(tmp_path / "checkpoints")
    assert not checkpoint_exists(ckdir)
    assert not jax_checkpoint.checkpoint_exists(ckdir)
    meta = {"epoch": 3, "best_acc": 0.5,
            "scheduler": {"lr": 0.01, "best": 0.5, "num_bad_epochs": 0},
            "model": {"model_type": "RadLIF", "layer_sizes": [H, H, C]}}
    save_checkpoint(ckdir, state, meta)
    # the same test as the JAX package's: best_model/ is a directory
    assert checkpoint_exists(ckdir) and jax_checkpoint.checkpoint_exists(ckdir)
    assert os.path.isdir(os.path.join(ckdir, "best_model"))
    with open(os.path.join(ckdir, "meta.json")) as f:
        assert json.load(f) == meta
    assert not [f for _, _, files in os.walk(ckdir) for f in files
                if f.endswith(".tmp")]
    # overwrite: the newer meta and state replace the older
    state.step = 9
    save_checkpoint(ckdir, state, dict(meta, epoch=4))
    fresh, _ = trainer("RadLIF", "scan", init_seed=1)
    fresh, got = restore_checkpoint(ckdir, fresh)
    assert got["epoch"] == 4 and fresh.step == 9
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k


def test_restore_needs_the_same_configuration(tmp_path):
    state, _ = trainer("RadLIF", "scan", init_seed=0)
    save_checkpoint(str(tmp_path), state, {})
    other = build_model("RadLIF", (B, T, F), [H + 1, H, C])
    with pytest.raises(RuntimeError):
        restore_checkpoint(str(tmp_path),
                           create_train_state(other, 1e-2, device="cpu"))


def test_checkpoint_holds_the_whole_state(tmp_path):
    state, step = trainer("GRU", "scan", init_seed=0)
    state, _ = step(state, *batch(1))
    save_checkpoint(str(tmp_path), state, {})
    tree = torch.load(str(tmp_path / "best_model" / "state.pt"),
                      weights_only=True)
    assert set(tree) == {"model", "optimizer", "generator", "step"}
    assert tree["step"] == 1
    assert np.array_equal(tree["generator"].numpy(),
                          state.generator.get_state().numpy())
