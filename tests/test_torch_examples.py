"""The port's examples (``examples_torch/``) run with ``--device cpu``
and tell the reference's examples' story: ``quickstart.py`` prints what
``examples/quickstart.py`` prints, line for line (waves, the serial
oracle, write skew under SI and Bohm, the pinned scan), and
``serve_batched.py`` serves the same requests in the same decode steps
with the same prefix hits and recycled pages (the tokens differ: the
parameters are random on both sides, from other generators)."""
import os
import re
import subprocess
import sys
from pathlib import Path

from examples import quickstart as ref_quickstart
from examples import serve_batched as ref_serve

ROOT = Path(__file__).resolve().parents[1]


def _port(script: str) -> str:
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples_torch" / script),
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_quickstart_prints_the_reference_story(capsys):
    ref_quickstart.main()
    want = capsys.readouterr().out
    got = _port("quickstart.py")
    assert got == want
    assert "[serializable]" in got and "found_frac=1.00" in got


def _serve_counts(text: str):
    served = re.search(r"served (\d+) requests / (\d+) tokens .* over "
                       r"(\d+) batched decode steps", text)
    hits = re.search(r"prefix-cache hits: (\d+) .*GC\): (\d+)", text)
    return served.groups() + hits.groups()


def test_serve_batched_matches_the_reference_schedule(capsys):
    ref_serve.main()
    want = _serve_counts(capsys.readouterr().out)
    got = _serve_counts(_port("serve_batched.py"))
    assert got == want
    assert int(got[3]) > 0
