r"""The runner of sides the timing scripts share (``time_adjoints.py``,
``time_nufft.py``, ``time_signal.py``): each side of a comparison runs the
calling script with ``--side ROOT`` in a process of its own, from that
side's root, in turns parent, change, change, parent; the timed lines are
summed up per case with the ratio of the change's best time to the
parent's.

A script builds its parser with :func:`parser`, runs its own side when
``--side`` is given, and otherwise hands over to :func:`drive`. A side
prints one JSON line per timed case, with ``root`` (the side's root),
``case``, ``ms`` and ``peak_gb``.
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

__all__ = ['card', 'drive', 'parser']


def parser(doc: str, steps: int, only: str) -> argparse.ArgumentParser:
    r"""``--parent``, ``--side``, ``--reps``, ``--steps`` (default
    ``steps``), ``--only`` (its help ``only``) and ``--out``."""
    ap = argparse.ArgumentParser(description=doc.split('\n\n')[0])
    ap.add_argument('--parent', type=Path, default=None)
    ap.add_argument('--side', type=Path, default=None)
    ap.add_argument('--reps', type=int, default=5)
    ap.add_argument('--steps', type=int, default=steps)
    ap.add_argument('--only', nargs='*', default=None, help=only)
    ap.add_argument('--out', type=Path, default=None)
    return ap


def card() -> str:
    r"""The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()


def drive(script: Path, root: Path, a, extra=(), case=None, lists=(),
          scalars=(), ratios=(('ratio', 'ms'),)) -> int:
    r"""Run ``script``'s sides for the parsed arguments ``a``: ``root``
    alone, or with ``a.parent`` in turns parent, change, change, parent;
    ``extra`` are further arguments of each side. Prints the card, every
    side's lines and last a JSON summary keyed by ``case(row)`` (default
    ``row['case']``): each side's ``ms`` and ``peak_gb`` and the fields
    ``lists`` as lists (``change``/``parent``, ``change_peak_gb``, …), the
    fields ``scalars`` as their last value, and for each ``(name, field)``
    of ``ratios`` min(change) / min(parent) of that field. Writes the timed
    lines to ``a.out`` if given. Returns the exit code: 1 if a side
    failed."""
    smi = card()
    print(smi, flush=True)
    order = [root] if a.parent is None else [a.parent.resolve(), root, root,
                                              a.parent.resolve()]
    rows = []
    for side in order:
        cmd = [sys.executable, str(script), '--side', str(side), '--reps',
               str(a.reps), '--steps', str(a.steps), *extra]
        if a.only:
            cmd += ['--only', *a.only]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              cwd=str(side), env=dict(os.environ))
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f'side {side} failed ({proc.returncode})', flush=True)
            return 1
        for line in proc.stdout.splitlines():
            print(line, flush=True)
            if line.startswith('{') and '"ms"' in line:
                rows.append(json.loads(line))
    if a.out is not None:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(''.join(json.dumps(r) + '\n' for r in rows))
    summary = {}
    for r in rows:
        key = 'change' if Path(r['root']) == root else 'parent'
        s = summary.setdefault(r['case'] if case is None else case(r), {})
        s.setdefault(key, []).append(r['ms'])
        for f in ('peak_gb', *lists):
            if f in r:
                s.setdefault(f'{key}_{f}', []).append(r[f])
        for f in scalars:
            if f in r:
                s[f'{key}_{f}'] = r[f]
    for s in summary.values():
        for name, f in ratios:
            c, p = (('change', 'parent') if f == 'ms' else
                    (f'change_{f}', f'parent_{f}'))
            if c in s and p in s:
                s[name] = min(s[c]) / min(s[p])
    print(json.dumps(dict(card=smi, cases=summary)), flush=True)
    return 0
