"""The port's training measurement tools (``tools/bench_train.py``,
``tools/profile_train.py``) on the CPU at toy sizes, through their
``main``, with deblur_plus built narrow (their ``build_model`` given tiny
widths, as ``tests/test_torch_eval.py`` narrows the deblur CLI's model).
On the CPU they run the plain versions and report no peak; the card's
numbers come from ``chip_smoke.py``'s ``train_measure`` phase."""
import functools

import pytest
import torch

from shiftnet_tpu_torch.models import build_model
from shiftnet_tpu_torch.tools import bench_train, profile_train, timing

TINY = dict(n_feats0=8, n_feats2=16, num_orbs=1, tfr_scale=4, shift_rounds=2)


@pytest.fixture(autouse=True)
def tiny_tools(monkeypatch):
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(bench_train, 'build_model',
                        functools.partial(build_model, **TINY))
    yield
    torch.set_num_threads(prev)


def test_bench_train_both_forms(capsys):
    out = bench_train.main(['both', '5', '32', '--steps', '2', '--warmup',
                            '1', '--device', 'cpu'])
    assert set(out) == {'unfused', 'fused'}
    for form, rec in out.items():
        assert rec['form'] == form and (rec['t'], rec['patch']) == (5, 32)
        assert len(rec['first_s']) == 1 and len(rec['steps_s']) == 2
        assert rec['median_s'] > 0 and rec['peak'] is None
        assert rec['loss'] == rec['loss'] and 'cpus' in rec['host_after']
    # the same seeded weights and batch: both forms start from one loss
    assert abs(out['fused']['loss'] - out['unfused']['loss']) < 1e-2
    text = capsys.readouterr().out
    assert 'bench_train: unfused T=5 32x32' in text
    assert 'fused / unfused s/step' in text and 'host before: load' in text


def test_profile_train_split(capsys):
    out = profile_train.main(['fused', '5', '32', '--iters', '2',
                              '--device', 'cpu'])['fused']
    for phase in ('forward', 'forward_backward', 'step'):
        assert len(out[phase]['calls_s']) == 2 and out[phase]['s'] > 0
    assert out['backward_s'] == pytest.approx(
        out['forward_backward']['s'] - out['forward']['s'])
    assert out['glue_s'] == pytest.approx(
        out['step']['s'] - out['forward_backward']['s'])
    assert 'trace' not in out  # the profiler's summary needs the card
    text = capsys.readouterr().out
    assert 'backward cost:' in text and 'optimizer+loss glue:' in text


@pytest.mark.parametrize('axis,card_gb,want', [('t', 23.5, 23),
                                               ('patch', 11.0, 640)])
def test_largest_steps_to_the_first_that_does_not_fit(monkeypatch, axis,
                                                      card_gb, want):
    """``largest`` on a card of ``card_gb`` where a step's peak is 1 GB a
    frame (``t``) or 0.1 GB a 64x64 tile (``patch``): it ends on the
    largest size that fits, having tried the next one."""
    tried = []

    def peak_gb(t, patch):
        return t if axis == 't' else 0.1 * (patch / 64) ** 2

    def fits(fused, t, patch, device='cuda'):
        tried.append(t if axis == 't' else patch)
        gb = peak_gb(t, patch)
        return None if gb > card_gb else int(gb * 1e9)

    class Card:
        total_memory = int(card_gb * 1e9)

    monkeypatch.setattr(bench_train, 'fits', fits)
    monkeypatch.setattr(torch.cuda, 'get_device_properties',
                        lambda device: Card)
    out = bench_train.largest(True, axis, 23, 256)
    assert out['largest'] == want
    assert want + (1 if axis == 't' else 64) in tried


def test_host_state_names_load_and_clocks():
    s = timing.host_state()
    assert s.startswith('load ') and 'cpus' in s and 'sm, max sm, W, C' in s
