"""The benchmark's plain reference against the program's plain model, at
tiny sizes on the CPU (this test imports both; the reference imports
nothing of the program)."""
import numpy as np
import pytest
import torch

from benchmark.reference import window as ref_window
from benchmark.reference.model import ARCH_DEFAULTS, Arch, Frames, GShiftNet
from shiftnet_tpu_torch.eval import window as port_window
from shiftnet_tpu_torch.models import CONFIGS, build_model, init_state

NARROW = {'deblur_plus': dict(n_feats0=8, n_feats2=48, num_orbs=1,
                              tfr_scale=4, shift_rounds=2),
          'denoise_plus': dict(n_feats0=8, n_feats2=48, num_orbs=1,
                               tfr_scale=4, shift_rounds=2),
          'deblur_small': dict(num_orbs=1, shift_rounds=2),
          'denoise_small': dict(num_orbs=1, shift_rounds=2)}


@pytest.mark.parametrize('variant', sorted(NARROW))
@pytest.mark.parametrize('block', [None, 2])
def test_reference_matches_the_port_plain_model(variant, block):
    torch.manual_seed(0)
    kw = NARROW[variant]
    port = build_model(variant, **kw)
    state = init_state(port, 5)
    port.load_state_dict(state)
    arch = Arch.from_config({k: getattr(CONFIGS[variant], k)
                             for k in ARCH_DEFAULTS}, **kw)
    ref = GShiftNet(arch)
    ref.load_state_dict(state, strict=True)
    x = torch.rand(6, 3, 32, 48)
    nm = torch.full((6, 1, 32, 48), 0.1) if arch.noise_map else None
    with torch.no_grad():
        want = port(x, nm)
        got = ref(x, nm, Frames(block))
    assert got.shape == want.shape
    assert (got - want).abs().max().item() < 1e-5


@pytest.mark.parametrize('h,w', [(480, 852), (720, 1280), (64, 100),
                                 (272, 448)])
def test_reference_tiles_match_the_protocol(h, w):
    assert ref_window.quadrant_pads(h, w) == port_window.quadrant_pads(h, w)
    assert ref_window.quadrant_slices(h, w) == port_window.quadrant_slices(
        h, w)
    assert ref_window.half_slices(h, w) == port_window.half_slices(h, w)
    assert ref_window.plan_for(h, w) == ('quadrant' if h % 8 or w % 8
                                         else 'full')


def test_reference_training_step_matches_the_port():
    """Three steps of the reference's L1 + clip + AdamW against the
    program's train_step, in float32 on the CPU."""
    from benchmark.reference import train as ref_train
    from shiftnet_tpu_torch.train.optim import OptimConfig, build_optimizer
    from shiftnet_tpu_torch.train.step import TaskConfig, train_step
    kw = NARROW['deblur_plus']
    port = build_model('deblur_plus', **kw)
    state = init_state(port, 9)
    port.load_state_dict(state)
    arch = Arch.from_config({k: getattr(CONFIGS['deblur_plus'], k)
                             for k in ARCH_DEFAULTS}, **kw)
    ref = GShiftNet(arch)
    ref.load_state_dict(state)
    cfg = OptimConfig(total_iters=100, scheduler_kwargs={'T_max': 100},
                      grad_clip=0.01)
    opt = build_optimizer(port, cfg)
    ropt = ref_train.Adam(ref.parameters(), lr=cfg.lr, betas=cfg.betas,
                          eps=cfg.eps, weight_decay=0.0, t_max=100,
                          eta_min=cfg.eta_min, clip=0.01)
    task = TaskConfig(kind='deblur', center_slice=(1, 1))
    g = torch.Generator().manual_seed(1)
    for _ in range(3):
        batch = {k: torch.rand((1, 5, 3, 32, 32), generator=g)
                 for k in ('lq', 'gt')}
        out = train_step(port, opt, task, batch, None)
        loss, _, _ = ref_train.step(ref, ropt, batch['lq'], batch['gt'],
                                    (1, 1))
        assert abs(float(out['loss']) - loss) < 1e-6
    rp = dict(ref.named_parameters())
    for k, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), rp[k].detach().numpy(),
                                   atol=2e-6)
