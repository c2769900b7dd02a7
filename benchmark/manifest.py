"""``BENCHMARK.json`` and the files it names: the manifest's rules on names
and units, and the lookup of a cell's configuration, traffic mix, limits,
metrics and per-layer readers by name."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NAME = re.compile(r'[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}')
UNIT = re.compile(r'[A-Za-z0-9_/%.-]{1,16}')
LINE = re.compile(r'[^\t\n\r]{1,200}')
TOP_KEYS = {'command', 'paths', 'run_seconds', 'configs', 'workloads',
            'end_to_end', 'per_layer'}
KEYS = {
    'configs': {'name', 'source', 'file', 'reduced', 'why'},
    'workloads': {'name', 'config', 'traffic', 'chips', 'why'},
    'end_to_end': {'name', 'unit', 'better', 'bound', 'source'},
    'per_layer': {'name', 'unit', 'better', 'source', 'layer', 'moves'},
}
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}


@dataclasses.dataclass
class Cell:
    """One workload of the manifest with everything it names."""
    name: str
    chips: int
    config: dict        # the configuration file
    traffic: dict       # the traffic mix's parameters
    limits: dict        # {number: limit} of the comparison
    end_to_end: list    # the manifest's end-to-end entries this cell reports
    per_layer: list     # ... and per-layer entries


def load(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / 'BENCHMARK.json').read_text())


def reports(entry: dict, workload: str, e2e_names: set[str]) -> bool:
    """Whether a cell reports a metric: those its ``workloads`` list, or
    without the key every cell (a per-layer metric: every cell reporting
    the end-to-end metric it moves)."""
    if 'workloads' in entry:
        return workload in entry['workloads']
    return entry.get('moves', entry['name']) in e2e_names | {entry['name']}


def cell(workload: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    man = load(root)
    by_name = {w['name']: w for w in man['workloads']}
    if workload not in by_name:
        raise KeyError(f'no workload {workload!r} in BENCHMARK.json; it has '
                       f'{sorted(by_name)}')
    w = by_name[workload]
    cfg = next(c for c in man['configs'] if c['name'] == w['config'])
    e2e = [m for m in man['end_to_end']
           if reports(m, workload, {m['name']})]
    names = {m['name'] for m in e2e}
    per_layer = [m for m in man['per_layer']
                 if reports(m, workload, names)]
    return Cell(
        name=workload, chips=int(w['chips']),
        config=json.loads((root / cfg['file']).read_text()),
        traffic=json.loads((root / 'benchmark' / 'traffic'
                            / f"{w['traffic']}.json").read_text()),
        limits=json.loads((root / 'benchmark' / 'limits'
                           / f'{workload}.json').read_text())['limits'],
        end_to_end=e2e, per_layer=per_layer)


def reader(metric: str, root: Path = ROOT):
    """The ``read(ctx)`` function of ``layer_metrics/<metric>.py``."""
    path = Path(root) / 'benchmark' / 'layer_metrics' / f'{metric}.py'
    spec = importlib.util.spec_from_file_location(
        f'benchmark_layer_metric_{metric.replace(".", "_")}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def problems(man: dict) -> list[str]:
    """What breaks the manifest's rules on names, units, keys and the
    cross-references between its entries (empty when none)."""
    out = []
    if set(man) != TOP_KEYS:
        out.append(f'top-level keys {sorted(man)}')
    seen: set[str] = set()
    for section, keys in KEYS.items():
        for e in man.get(section, []):
            extra = set(e) - keys - ({'workloads'} if section in (
                'end_to_end', 'per_layer') else set())
            if extra or not keys <= set(e):
                out.append(f'{section} {e.get("name")}: keys {sorted(e)}')
            for k in ('name', 'config', 'traffic'):
                if k in e and not NAME.fullmatch(str(e[k])):
                    out.append(f'{section}: bad {k} {e[k]!r}')
            lines = ('why', 'source') if section == 'configs' else (
                'why', 'layer')
            for k in lines:
                if k in e and not LINE.fullmatch(str(e[k])):
                    out.append(f'{section} {e["name"]}: bad {k}')
            if 'unit' in e and not UNIT.fullmatch(e['unit']):
                out.append(f'{section} {e["name"]}: bad unit {e["unit"]!r}')
            if 'better' in e and e['better'] not in ('lower', 'higher'):
                out.append(f'{section} {e["name"]}: better {e["better"]!r}')
            if section in ('end_to_end', 'per_layer') and \
                    e.get('source') not in SOURCES:
                out.append(f'{section} {e["name"]}: source {e.get("source")}')
            for k in e.get('reduced', []):
                if not NAME.fullmatch(k):
                    out.append(f'{section} {e["name"]}: bad reduced key {k}')
            if section in ('configs', 'workloads', 'end_to_end', 'per_layer'):
                key = (section if section in ('configs', 'workloads')
                       else 'metric', e.get('name'))
                if key in seen:
                    out.append(f'duplicate {key}')
                seen.add(key)
    e2e = {m['name'] for m in man.get('end_to_end', [])}
    cells = {w['name'] for w in man.get('workloads', [])}
    for m in man.get('per_layer', []):
        if m.get('moves') not in e2e:
            out.append(f'per_layer {m["name"]}: moves {m.get("moves")}')
    for m in man.get('end_to_end', []) + man.get('per_layer', []):
        for w in m.get('workloads', []):
            if w not in cells:
                out.append(f'{m["name"]}: unknown workload {w}')
    return out
