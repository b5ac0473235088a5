"""A run with the timed path broken underneath comes out not correct, by the
cell's own limits: a serving cell's answer altered where it is produced,
and half of its batch left out; a training cell's step that leaves the
state unchanged, half of its batch left out with the loss the mean over
the rest, an EMA left unchanged and BN running statistics left unmoved;
a rendering cell's image altered where the render produces it."""

import pytest
import torch

from port_bench.core import spec
from port_bench.tests._tiny import cells, tiny_run


def _broken_evaluator(monkeypatch, fault):
    from yoloseries_tpu_torch.evaluation import yolov5 as ev_mod

    call = ev_mod.Evaluator.__call__
    monkeypatch.setattr(ev_mod.Evaluator, "__call__",
                        lambda self, img: fault(call(self, img).clone()))


def move_one(monkeypatch):
    def fault(dets):
        live = torch.nonzero(dets[..., 4] > 0)
        i, j = live[len(live) // 2].tolist()
        dets[i, j, :4] += 3.0  # one box moved by 3 px
        return dets

    _broken_evaluator(monkeypatch, fault)


def serve_half_left_out(monkeypatch):
    def fault(dets):
        dets[dets.shape[0] // 2:] = 0.0
        return dets

    _broken_evaluator(monkeypatch, fault)


def state_unchanged(monkeypatch):
    from yoloseries_tpu_torch.train import optim

    monkeypatch.setattr(optim.Optimizer, "_group_step", lambda self, g, ps: None)


def train_half_left_out(monkeypatch):
    from yoloseries_tpu_torch.train import trainer

    make = trainer.make_train_step

    def make_half(loss, *args, accumulate=1, **kw):
        step = make(loss, *args, accumulate=accumulate, **kw)

        def half(state, batch):
            mb = batch["img"].shape[0] // accumulate
            rows = torch.cat([torch.arange(i * mb, i * mb + mb // 2) for i in range(accumulate)])
            rows = rows.to(batch["img"].device)
            return step(state, {k: v[rows] for k, v in batch.items()})

        return half

    monkeypatch.setattr(trainer, "make_train_step", make_half)


def ema_unchanged(monkeypatch):
    from yoloseries_tpu_torch.train import state

    monkeypatch.setattr(state, "ema_update", lambda ema, new, n, ratio=0.9999: None)


def bn_stats_frozen(monkeypatch):
    from torch import nn

    from yoloseries_tpu_torch.nn import layers

    def init(self, channels, eps=1e-3):
        nn.BatchNorm2d.__init__(self, channels, eps=eps, momentum=0.0)

    monkeypatch.setattr(layers.BatchNorm, "__init__", init)


def render_altered(monkeypatch):
    from yoloseries_tpu_torch.train import trainer

    render = trainer.render_batch

    def altered(*args, **kw):
        img = render(*args, **kw).clone()
        img[0, 0, 0, 0] ^= 1  # one byte of the first image
        return img

    monkeypatch.setattr(trainer, "render_batch", altered)


FAULTS = {"serve_closed": [move_one, serve_half_left_out],
          "train_update": [state_unchanged, train_half_left_out, ema_unchanged,
                           bn_stats_frozen]}


def _faults(cell_name):
    bench = spec.load_bench()
    t = spec.traffic(spec.cell(bench, cell_name)["traffic"])
    extra = [render_altered] if t.get("augmentation") == "device" else []
    return FAULTS[t["kind"]] + extra


CASES = [(c, f) for c in cells() for f in _faults(c)]


@pytest.mark.parametrize("cell_name", cells())
def test_sound_run_is_correct(cell_name):
    torch.set_num_threads(1)
    assert tiny_run(cell_name)["correct"] is True


@pytest.mark.parametrize("cell_name,fault", CASES, ids=[f"{c}-{f.__name__}" for c, f in CASES])
def test_broken_run_is_not_correct(monkeypatch, cell_name, fault):
    torch.set_num_threads(1)
    fault(monkeypatch)
    out = tiny_run(cell_name)
    assert out["correct"] is False
    assert any(v > lim for _, v, lim in out["checks"])
