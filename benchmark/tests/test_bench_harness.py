"""The harness on the CPU, on the tiny cells of ``tiny.py``: the manifest's
rules, the lookup by name, the window of whole units, the result line,
the trace's reduction, and ``correct`` coming out false for each fault a
cell can have, planted underneath the timed path."""
import json
import time
import types

import pytest
import torch

from benchmark import harness, manifest, run
from benchmark.tests.tiny import make_root
from benchmark.trace import Op, Trace


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    torch.set_num_threads(4)
    return make_root(tmp_path_factory.mktemp('bench'))


def cell_run(root, name, trace=False, seed=2**31 + 7, seconds=0.01):
    return run.run_cell(manifest.cell(name, root), seed, seconds, trace,
                        'cpu', time.time(), root)


def test_manifest_follows_its_rules():
    man = manifest.load()
    assert manifest.problems(man) == []
    assert len(json.dumps(man)) < 64 * 1024
    for w in man['workloads']:
        c = manifest.cell(w['name'])
        assert c.chips == 1
        assert {m['name'] for m in c.end_to_end} >= {'setup_s'}
        assert len(c.end_to_end) >= 2 and c.per_layer
        for m in c.per_layer:  # every reader is there
            assert callable(manifest.reader(m['name']))
    for m in man['per_layer']:
        if m['name'].endswith('_roofline.restore') or 'mfu' in m['name']:
            assert m['unit'] == '%'


@pytest.mark.parametrize('bad', ['a b', 'a,b', 'a/b', '.a', 'x' * 65, 'µs'])
def test_bad_names_are_caught(bad):
    man = manifest.load()
    man['per_layer'] = [dict(man['per_layer'][0], name=bad)]
    assert manifest.problems(man)


@pytest.mark.parametrize('unit', ['tokens per second', '', 'µs',
                                  'x' * 17])
def test_bad_units_are_caught(unit):
    man = manifest.load()
    man['end_to_end'] = [dict(man['end_to_end'][0], unit=unit)]
    assert manifest.problems(man)


def test_window_ends_at_a_unit_boundary():
    began = []

    def unit(i):
        began.append(time.perf_counter())
        time.sleep(0.03)
    w = harness.window(unit, 0.1, 'cpu')
    assert w.units == len(began) >= 3
    assert began[-1] - began[0] < 0.1 + 1e-3  # the last began in time
    assert w.wall_s >= 0.03 * w.units  # and ran to its end
    assert harness.window(unit, 10.0, 'cpu', max_units=2).units == 2


def test_trace_busy_and_idle():
    ms = 1_000_000
    tr = Trace(Op('benchmark.window', 0, 100 * ms),
               [Op('k1', 10 * ms, 30 * ms), Op('k2', 20 * ms, 40 * ms),
                Op('Memcpy HtoD (Pageable -> Device)', 60 * ms, 70 * ms)],
               [Op('aten::copy_', 41 * ms, 59 * ms)],
               [Op('benchmark.unit', 0, 100 * ms)])
    assert tr.busy_s == pytest.approx(0.04)
    assert tr.window_s == pytest.approx(0.1)
    assert tr.device_s(tr.copies()) == pytest.approx(0.01)
    gaps = dict(tr.idle_gaps())
    assert gaps['benchmark.unit:aten::copy_'] == pytest.approx(0.02)
    assert gaps['benchmark.unit:python'] == pytest.approx(0.04)


@pytest.mark.parametrize('name', ['tiny.window', 'tiny_dn.quadrant',
                                  'tiny.step'])
def test_sound_run_is_correct_and_its_line_has_the_keys(root, name):
    res = cell_run(root, name)
    assert list(res) == ['correct', 'attempted', 'failed', 'metrics',
                         'device', 'compared']
    assert res['correct'] is True, res['compared']
    assert res['attempted'] >= 1 and res['failed'] == 0
    c = manifest.cell(name, root)
    assert set(res['metrics']) == {m['name'] for m in c.end_to_end}
    assert all(v['value'] > 0 for v in res['metrics'].values())
    assert set(res['device']) == {'platform', 'kind', 'count',
                                  'memory_peak_bytes'}
    for v in res['compared'].values():
        assert set(v) == {'value', 'limit'}


def test_traced_run_line_and_a_new_metric_file(root):
    """A reader file and a manifest entry make a new per-layer metric;
    a new traffic file and an entry make a new cell; nothing else is
    edited."""
    man = json.loads((root / 'BENCHMARK.json').read_text())
    (root / 'benchmark' / 'layer_metrics' / 'extra.units.py').write_text(
        'def read(ctx):\n    return ctx.units\n')
    man['per_layer'].append({
        'name': 'extra.units', 'unit': 'count', 'better': 'higher',
        'source': 'program_counter', 'layer': 'entry',
        'moves': 'restore_fps', 'workloads': ['tiny.window2']})
    tr = json.loads((root / 'benchmark' / 'traffic' / 'window.json')
                    .read_text())
    tr['pool'] = 1
    (root / 'benchmark' / 'traffic' / 'window2.json').write_text(
        json.dumps(tr))
    (root / 'benchmark' / 'limits' / 'tiny.window2.json').write_text(
        (root / 'benchmark' / 'limits' / 'tiny.window.json').read_text())
    man['workloads'].append({'name': 'tiny.window2', 'config': 'tiny',
                             'traffic': 'window2', 'chips': 1,
                             'why': 'a cell added by files alone'})
    for m in man['end_to_end']:
        if 'restore_fps' == m['name']:
            m['workloads'].append('tiny.window2')
    (root / 'BENCHMARK.json').write_text(json.dumps(man))
    res = cell_run(root, 'tiny.window2', trace=True)
    assert list(res) == ['correct', 'attempted', 'failed', 'metrics',
                         'device', 'breakdown', 'compared']
    assert res['correct'] is True
    assert res['metrics']['extra.units']['value'] == res['attempted'] >= 1
    assert {'busy_s', 'window_s'} <= set(res['device'])
    assert set(res['breakdown']) == {'device_ops', 'idle_gaps'}
    assert len(res['breakdown']['idle_gaps']) <= 10


def test_main_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    rc = run.main(['--workload', 'deblur_plus.gopro720_w48', '--seed', '1',
                   '--seconds', '1', '--trace', '0'])
    assert rc != 0
    assert capsys.readouterr().out == ''


# -- faults underneath the timed path: correct must come out false ----------

def _model_forward(monkeypatch, change):
    from shiftnet_tpu_torch.models import gshift
    orig = gshift.GShiftNet.forward

    def forward(self, x, noise_map=None):
        return change(orig(self, x, noise_map), x)
    monkeypatch.setattr(gshift.GShiftNet, 'forward', forward)


def _identity(out, x):
    """A step that returns its state unchanged: the window's input."""
    h = (x.shape[0] - out.shape[0]) // 2
    return x[h:h + out.shape[0]].clone()


def _half_left_out(out, x):
    """Half of the window's frames left out (given back unrestored)."""
    h = (x.shape[0] - out.shape[0]) // 2
    half = out.shape[0] // 2
    return torch.cat([out[:half], x[h + half:h + out.shape[0]]])


def _altered(out, x):
    """One answer altered where it is produced."""
    out = out.clone()
    out[0] += 1e-3
    return out


@pytest.mark.parametrize('fault', [_identity, _half_left_out, _altered])
@pytest.mark.parametrize('name', ['tiny.window', 'tiny_dn.quadrant'])
def test_restore_faults_fail(root, monkeypatch, name, fault):
    _model_forward(monkeypatch, fault)
    assert cell_run(root, name)['correct'] is False


def test_train_state_unchanged_fails(root, monkeypatch):
    from shiftnet_tpu_torch.train import step
    orig = step.train_step

    def unchanged(model, *args, **kw):
        saved = [p.detach().clone() for p in model.parameters()]
        out = orig(model, *args, **kw)
        with torch.no_grad():
            for p, v in zip(model.parameters(), saved):
                p.copy_(v)
        return out
    monkeypatch.setattr(step, 'train_step', unchanged)
    res = cell_run(root, 'tiny.step')
    assert res['correct'] is False
    assert res['compared']['change_gap']['value'] > 0.9


def test_train_half_batch_fails(root, monkeypatch):
    from shiftnet_tpu_torch.train import step
    orig = step.build_loss

    def build_loss(spec):
        fn = orig(spec)

        def half(pred, target, generator=None, **kw):
            h = pred.shape[1] // 2
            return fn(pred[:, :h], target[:, :h], generator)
        return half
    monkeypatch.setattr(step, 'build_loss', build_loss)
    assert cell_run(root, 'tiny.step')['correct'] is False


def test_train_altered_answer_fails(root, monkeypatch):
    _model_forward(monkeypatch, _altered)
    assert cell_run(root, 'tiny.step')['correct'] is False


@pytest.mark.cuda
def test_cell_on_the_card():
    """A short run of the first cell on the card (skipped without one)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    res = run.run_cell(manifest.cell('deblur_plus.gopro720_w48'), 5, 2.0,
                       False, 'cuda', time.time())
    assert res['correct'] is True, res['compared']
    assert res['device']['platform'] == 'gpu'


def test_readers_find_nothing_without_a_device_trace():
    tr = Trace(Op('benchmark.window', 0, 10), [], [], [])
    ctx = types.SimpleNamespace(kind='restore', trace=tr, calls=[], units=1,
                                window_s=1e-8, model_flops=1.0,
                                peak_flops=1.0, peak_bytes=0, device='cpu')
    for m in manifest.load()['per_layer']:
        assert manifest.reader(m['name'])(ctx) is None, m['name']


def test_train_stage_update_lost_fails(root, monkeypatch):
    """One stage's update lost where the optimizer produces it: the
    worst leaf's change catches it, where the median leaf's would not."""
    from shiftnet_tpu_torch.train import step
    orig = step.train_step

    def lost(model, *args, **kw):
        saved = {k: p.detach().clone() for k, p in model.named_parameters()
                 if k.startswith('orb1.')}
        out = orig(model, *args, **kw)
        with torch.no_grad():
            for k, p in model.named_parameters():
                if k in saved:
                    p.copy_(saved[k])
        return out
    monkeypatch.setattr(step, 'train_step', lost)
    res = cell_run(root, 'tiny.step')
    assert res['correct'] is False
    assert res['compared']['change_gap']['value'] > 0.5
