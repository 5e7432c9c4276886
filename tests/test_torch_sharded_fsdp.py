"""What FSDP and split expert banks hold a rank in the port's sharded step
(``training.make_train_step_sharded``), counted by the dry run's step on
``meta`` tensors (``launch.dryrun``: ``Census`` follows every storage the
step makes, ``DryMesh`` counts the collectives' bytes).

* Depth: the step's peak above its arguments grows a layer by at most
  0.75 of one block's leaves gathered whole (in the masters' dtype, the
  dry run's bf16) on a (4, 1) mesh with FSDP forced on: a rank holds its
  blocks and one block gathered at a time (``Constrain.fsdp``), each
  gradient back cut to its block.  Gathering the tree for the whole step,
  with its whole f32 gradients, grows about 3.8 blocks a layer here.
* The per-block gather sits inside the block's checkpoint region: the
  step all-gathers every FSDP leaf twice a microbatch (the forward and the
  backward's recompute) and nothing else.
* Split banks: reduced mixtral with 3 experts on (1, 2), which "model"
  does not divide; no tensor the step makes has a whole bank's shape (each
  rank computes every expert on its n_out columns, ``split_banks``).

The values of these steps are held elsewhere: every ``2d`` case with FSDP
and the split-bank cases of ``test_torch_sharded_training.py`` and
``test_torch_sharded_moe.py`` against the single-device step and JAX's.
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.launch import dryrun
from repro_torch.optim.adamw import adamw
from repro_torch.runtime import sharding
from repro_torch.runtime.collectives import DryMesh
from repro_torch.training import make_train_step_sharded

SMALL = dict(d_model=64, n_heads=4, d_ff=128, vocab_size=128)


def _cell(arch, n_layers, mesh_shape, global_batch, seq, **cfg_kw):
    """(config, masters, a ``dryrun.Cell`` of one sharded ``2d`` step with
    FSDP on, on ``meta``)."""
    cfg = get_config(arch).reduced(n_layers=n_layers, **SMALL, **cfg_kw)
    mesh = DryMesh(mesh_shape)
    params = dryrun.bf16_params(cfg)
    ctx = dryrun.make_ctx(cfg, mesh, global_batch, mode="qat")
    opt = adamw()
    p = sharding.shard_params(mesh, params, fsdp=True)
    fn = make_train_step_sharded(cfg, ctx, opt, mesh,
                                 global_batch=global_batch)
    batch = {k: torch.zeros_like(v, device="meta") for k, v in
             make_batch_specs(cfg, global_batch, seq, device="meta").items()}
    return cfg, params, dryrun.Cell(fn, (p, opt.init(p), batch), mesh, 0)


def _block_bytes(params) -> int:
    return sum(t.numel() * t.element_size()
               for t in params["layers"][0].buffers())


@pytest.mark.parametrize("arch", ["bitnet-0.73b", "mixtral-8x22b"])
def test_fsdp_peak_grows_by_a_share_of_a_block_a_layer(arch):
    """Peak above the arguments at 2 and at 8 layers on (4, 1): at most
    0.75 of a block a layer (the rank's gradient blocks and a saved
    residual reckon about 0.25-0.5)."""
    peaks = {}
    for n_layers in (2, 8):
        _, params, cell = _cell(arch, n_layers, (4, 1), 8, 32)
        mem = dryrun.estimate(cell)["memory"]
        peaks[n_layers] = mem["peak_bytes_est"] - mem["argument_bytes"]
    growth = (peaks[8] - peaks[2]) / 6 / _block_bytes(params)
    assert 0 < growth <= 0.75, (peaks, growth)


def test_fsdp_leaves_are_gathered_in_the_forward_and_the_recompute():
    """bitnet 4 layers on (4, 1), 2 microbatches: the step's all-gathers
    are each FSDP leaf whole, twice a microbatch (the forward, the
    recompute), in the masters' dtype."""
    cfg, params, cell = _cell("bitnet-0.73b", 4, (4, 1), 16, 32)
    cell.fn = make_train_step_sharded(
        cfg, dryrun.make_ctx(cfg, cell.mesh, 16, mode="qat"), adamw(),
        cell.mesh, global_batch=16, microbatches=2)
    specs = sharding.param_specs(cell.mesh, params, fsdp=True)
    whole = sum(t.numel() * t.element_size()
                for n, t in params.named_buffers() if "data" in specs[n])
    assert whole > 0
    got = dryrun.estimate(cell)["collectives"]
    assert got["all-gather"] == 2 * 2 * whole, (got, whole)


class _Shapes(TorchDispatchMode):
    """The shape of every tensor an op makes."""

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.shapes.add(tuple(t.shape))
        return out


def test_split_banks_are_computed_where_they_lie():
    """Reduced mixtral, 3 experts on (1, 2): the banks are split inside
    each expert (JAX's spec), the step makes their columns' shapes and
    never a whole bank's, nor a whole bank's gradient."""
    cfg, params, cell = _cell("mixtral-8x22b", 1, (1, 2), 4, 32,
                              n_experts=3)
    moe = cell.args[0]["layers"][0]["moe"]
    assert cfg.n_experts == 3
    whole = {tuple(t.shape) for n, t in params["layers"][0]["moe"]
             .named_buffers() if n.endswith("_w")}
    local = {tuple(t.shape) for n, t in moe.named_buffers()
             if n.endswith("_w")}
    assert whole == {(3, 64, 128), (3, 128, 64)}, whole
    assert local == {(3, 64, 64), (3, 128, 32)}, local
    with _Shapes() as seen:
        cell.fn(*cell.args)
    assert local <= seen.shapes
    assert not whole & seen.shapes, whole & seen.shapes
