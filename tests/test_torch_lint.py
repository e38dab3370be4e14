"""Port parity, the static rules and the lint gate (``analysis/lint.py``,
``analysis/rules/``, ``analysis/waivers.py``, ``cli/lint.py``): on shared
fixtures — a positive and a negative one for every framework-agnostic
rule, the shapes of the JAX package's own rule tests — the port's
``lint_source`` gives JAX's findings (rule, line, column, symbol,
message); ``host-sync-in-loop`` gives JAX's findings on the syncs both
count (``.item()``, ``.tolist()``) and adds torch's (``.cpu()``,
``.numpy()``, ``torch.cuda.synchronize``) in train/ and serve/ host
loops only; the waiver reader parses and matches as JAX's, and rejects
the same bad files; the port's package lints clean with its waivers (JAX's
twin: ``test_repo_lints_clean``); and ``cli/lint.py`` exits 0 on the tree
and 1 on a dirty fixture, with JAX's ``--json``, ``--rules``,
``--changed`` and ``--metrics-dir``."""

import json
import os
import textwrap

import pytest

from pytorch_distributed_training_tpu.analysis import lint as jax_lint
from pytorch_distributed_training_tpu.analysis import waivers as jax_waivers
from pytorch_distributed_training_tpu_torch.analysis import lint
from pytorch_distributed_training_tpu_torch.analysis import waivers
from pytorch_distributed_training_tpu_torch.analysis.rules import RULE_IDS
from pytorch_distributed_training_tpu_torch.cli import lint as lint_cli

pytestmark = pytest.mark.concurrency

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# rule -> (positive fixture, negative fixture)
FIXTURES = {
    "thread-shared-mutable": ("""
        import threading

        class Loop:
            def __init__(self):
                self.failed = False
                self._t = threading.Thread(target=self._run, daemon=True)

            def _run(self):
                self.failed = True

            def health(self):
                return self.failed

        class Worker:
            def __init__(self, buf):
                self.buf = buf
                self._t = threading.Thread(target=self.run, daemon=True)

            def run(self):
                self.buf.append(1)

        class Owner:
            def __init__(self):
                self.items = []
                self.w = Worker(self.items)

            def reset(self):
                self.items = []
        """, """
        import threading

        class Loop:
            def __init__(self):
                self._lock = threading.Lock()
                self._stop = threading.Event()
                self.n = 0
                self._t = threading.Thread(target=self._run, daemon=True)

            def _run(self):
                while not self._stop.is_set():
                    with self._lock:
                        self._advance()

            def _advance(self):
                self.n += 1

            def snapshot(self):
                with self._lock:
                    return self.n
        """),
    "unlocked-rmw": ("""
        import threading

        class Router:
            def __init__(self):
                self._lock = threading.Lock()
                self.routed = 0
                self.seen = {}

            def route(self, k):
                self.routed += 1
                self.seen[k] = 1
        """, """
        import queue

        class Plain:
            def __init__(self):
                self.n = 0
                self.q = queue.Queue()

            def bump(self):
                self.n += 1
                self.q.put(1)
        """),
    "lock-order-cycle": ("""
        import threading

        class AB:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.RLock()

            def one(self):
                with self._a:
                    with self._b:
                        pass

            def two(self):
                with self._b:
                    self._take_a()

            def _take_a(self):
                with self._a:
                    pass
        """, """
        import threading

        class AB:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def one(self):
                with self._a:
                    with self._b:
                        pass

            def two(self):
                with self._a:
                    with self._b:
                        pass
        """),
    "blocking-call-in-lock": ("""
        import threading
        import time

        class M:
            def __init__(self):
                self._lock = threading.Lock()
                self._done = threading.Event()

            def bad_wait(self):
                with self._lock:
                    self._done.wait()

            def bad_http(self, conn):
                with self._lock:
                    conn.request("GET", "/x")
                    time.sleep(1)
        """, """
        import threading

        class M:
            def __init__(self):
                self._lock = threading.Lock()
                self._cond = threading.Condition(self._lock)
                self._done = threading.Event()

            def ok_bounded(self):
                with self._lock:
                    self._done.wait(0.5)

            def ok_condition(self):
                with self._cond:
                    self._cond.wait()
        """),
    "non-daemon-thread": ("""
        import threading

        def go():
            t = threading.Thread(target=print)
            t.start()
        """, """
        import threading

        def go():
            t = threading.Thread(target=print)
            t.start()
            t.join(5.0)
            threading.Thread(target=print, daemon=True).start()
        """),
    "unbounded-wait": ("""
        import threading

        def collect(req, q, t):
            req.done.wait()
            q.get()
            t.join()
        """, """
        import threading

        def collect(req, cond):
            req.done.wait(1.0)
            with cond:
                cond.wait()
        """),
    "mutable-default": ("""
        def f(x, acc=[], opts={}, *, seen=set()):
            acc.append(x)
            return acc, opts, seen
        """, """
        def f(x, acc=None, shape=(1, 2)):
            return acc or [x], shape
        """),
}


def _findings(mod, src, path="<string>", rules=None):
    found = mod.lint_source(textwrap.dedent(src), path=path)
    return [(f.rule, f.line, f.col, f.symbol, f.message) for f in found
            if rules is None or f.rule in rules]


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_agnostic_rules_match_jax(rule):
    """Exact: every finding of the port's rules on the fixtures equals
    JAX's, and the positive fixture trips the rule it is for."""
    for i, src in enumerate(FIXTURES[rule]):
        got = _findings(lint, src)
        want = _findings(jax_lint, src, rules=set(RULE_IDS))
        assert got == want
        hits = [f for f in got if f[0] == rule]
        assert bool(hits) == (i == 0), (rule, got)


HOST_LOOP = """
    import torch

    def epoch_loop(batches, step, state):
        for b in batches:
            loss = step(state, b)
            print(loss.item(), loss.tolist())
            host = loss.cpu()
            arr = loss.numpy()
            torch.cuda.synchronize()
        last = loss.item()
        return host, arr, last
    """


@pytest.mark.parametrize("where", ["train", "serve", "data"])
def test_host_sync_in_loop(where):
    path = f"pytorch_distributed_training_tpu_torch/{where}/x.py"
    jpath = f"pytorch_distributed_training_tpu/{where}/x.py"
    got = [f[:4] for f in _findings(lint, HOST_LOOP, path)]
    if where == "data":     # not a hot subsystem in either package
        assert got == [] and _findings(jax_lint, HOST_LOOP, jpath) == []
        return
    # the syncs both packages count give the same findings
    want = [f[:4] for f in _findings(jax_lint, HOST_LOOP, jpath)
            if f[0] == "host-sync-in-loop"]
    both = [f for f in got if f[1] == 7]
    assert [(r, ln, c) for r, ln, c, _ in both] == [
        (r, ln, c) for r, ln, c, _ in want]
    assert {f[3] for f in got} == {"epoch_loop"}
    # and torch's own: .cpu(), .numpy(), torch.cuda.synchronize; the
    # .item() after the loop is not in it
    assert [(f[1], f[2]) for f in got] == [
        (7, 14), (7, 27), (8, 15), (9, 14), (10, 8)]


WAIVERS = """
# comment
[[waiver]]
rule = "unlocked-rmw"
file = "*/pkg/*.py"
symbol = "Router"
reason = "single-writer counter"

[[waiver]]
rule = "mutable-default"
file = "*/pkg/unused.py"
reason = "nothing there"
"""


def test_waivers_parse_match_and_errors_as_jax(tmp_path):
    got = waivers.parse_waivers_toml(WAIVERS)
    want = jax_waivers.parse_waivers_toml(WAIVERS)
    assert [vars(w) for w in got] == [vars(w) for w in want]
    for bad in ('[[waiver]]\nrule = "x"\nfile = "y"\n',
                '[[waiver]]\nrule = "x"\nfile = "y"\nreason = " "\n',
                'rule = "x"\n', '[[waiver]]\nrule = 1\n',
                '[[waiver]]\nrule = "x"\nfile = "y"\nreason = "r"\n'
                'extra = "z"\n'):
        with pytest.raises(ValueError) as e1:
            waivers.parse_waivers_toml(bad)
        with pytest.raises(ValueError) as e2:
            jax_waivers.parse_waivers_toml(bad)
        assert str(e1.value) == str(e2.value)
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "router.py").write_text(textwrap.dedent(
        FIXTURES["unlocked-rmw"][0]))
    report = lint.lint_paths([str(pkg)], got)
    jreport = jax_lint.lint_paths([str(pkg)], want, rule_ids=RULE_IDS)
    assert report.findings == [] and len(report.waived) == 2
    assert [(f.rule, f.line) for f, _ in report.waived] == [
        (f.rule, f.line) for f, _ in jreport.waived]
    assert [w.file for w in report.unused_waivers] == ["*/pkg/unused.py"]
    rec = lint.summary_record(report)
    assert rec == jax_lint.summary_record(jreport)
    assert rec["clean"] and rec["unused_waiver_rules"] == ["mutable-default"]


def test_port_package_lints_clean_with_its_waivers():
    """The acceptance gate: the port's package lints clean modulo its
    documented waivers, and no waiver has rotted."""
    report = lint.lint_paths(
        [os.path.join(REPO, "pytorch_distributed_training_tpu_torch")],
        waivers.load_waivers(lint.DEFAULT_WAIVERS))
    assert report.errors == []
    assert report.findings == [], "\n".join(
        f.format() for f in report.findings)
    assert report.unused_waivers == []
    assert report.files > 100


def test_lint_cli_check_json_rules_changed_and_metrics(tmp_path, capsys):
    assert lint_cli.main(["--check"]) == 0
    assert "0 finding(s)" in capsys.readouterr().out
    dirty = tmp_path / "dirty.py"
    dirty.write_text("def f(x, acc=[]):\n    return acc\n")
    mdir = str(tmp_path / "metrics")
    assert lint_cli.main(["--check", str(dirty), "--metrics-dir",
                          mdir]) == 1
    assert "mutable-default" in capsys.readouterr().out
    (rec,) = [json.loads(line) for line in
              open(os.path.join(mdir, "metrics.jsonl"))]
    assert rec["record"] == "lint_summary" and rec["findings"] == 1
    assert lint_cli.main(["--json", "--rules", "unbounded-wait",
                          str(dirty)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["findings"] == 0 and out["files"] == 1
    with pytest.raises(SystemExit):
        lint_cli.main(["--rules", "no-such-rule"])
    assert lint_cli.main(["--changed", "--check"]) == 0
    capsys.readouterr()
