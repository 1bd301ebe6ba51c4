"""The JAX package's static passes (pumiumtally_tpu/analysis), run over
the PyTorch port read-only: nothing of analysis/ changes, and the port
is held to them.

- ``lint_paths`` over ``pumiumtally_tpu_torch/`` and ``chip_smoke.py``
  gives no diagnostic;
- ``audit_contracts(root=<port>)`` exits 0 and its facade rows equal the
  JAX package's (hook status, defining class and module; line numbers
  aside);
- the wire schema extracted from the port's ``service/server.py``
  equals the JAX server's (ops, required fields, replies, error keys),
  and the encoders that speak it (the port's server, tools/loadgen.py,
  which the port's ``loadgen`` verb runs, and the port's
  multi_client_service example) have no finding;
- planted violations in a copy of a port module are flagged: JL301
  (state written from two thread roots without a lock), JL303 (a
  blocking wait under a lock) and JL501 (set order into an ordered
  sink). So the passes see the port's idiom.

The passes' limits on torch code are in ROADMAP.md queue 1 item 9:
JL502 and JL503 look only for JAX sinks, and JL301 only at the classes
``analysis/concurrency.py`` names in ``THREAD_ROOTS``.
"""

from pathlib import Path

from pumiumtally_tpu.analysis import audit_contracts, lint_paths
from pumiumtally_tpu.analysis import wire

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "pumiumtally_tpu_torch"


def test_port_has_no_lint_diagnostic():
    diags = lint_paths([str(PORT), str(ROOT / "chip_smoke.py")])
    assert [d.render() for d in diags] == []


def _rows(report: dict) -> list:
    """Each facade row with its hooks' status, defining class and module
    (their line numbers differ between the packages)."""
    return [{**{k: v for k, v in row.items() if k != "hooks"},
             "hooks": {point: {**h, "defined_in":
                               h.get("defined_in", "").split(":")[0]}
                       for point, h in row["hooks"].items()}}
            for row in report["facades"]]


def test_port_contracts_equal_the_jax_package():
    report, code = audit_contracts(root=str(PORT))
    want, want_code = audit_contracts()
    assert code == 0 == want_code
    assert _rows(report) == _rows(want)
    assert report["engine_kinds_dispatched"] == \
        want["engine_kinds_dispatched"]
    assert all(h["status"] != "MISSING" for row in report["facades"]
               for h in row["hooks"].values())


def test_port_wire_schema_equals_the_jax_server():
    got = wire._extract_schema(str(PORT / "service" / "server.py"))
    want = wire._extract_schema(str(ROOT / wire.SERVER_FILE))
    assert len(got.ops) == 14
    assert got.ops == want.ops
    assert got.required == want.required
    assert got.replies == want.replies
    assert got.error_keys == want.error_keys
    for rel in ("pumiumtally_tpu_torch/service/server.py",
                "tools/loadgen.py",
                "pumiumtally_tpu_torch/examples/multi_client_service.py"):
        stats, findings = wire._audit_encoder(str(ROOT / rel), rel, got)
        assert findings == [], rel
    # The load generator really speaks the protocol: the audit read its
    # requests, not an empty file.
    assert wire._audit_encoder(str(ROOT / "tools/loadgen.py"),
                               "tools/loadgen.py", got)[0]["requests"] > 0


_JL301 = "        self._planted_state = 1  # PLANTED JL301\n"
_JL303 = '''
    def planted_wait(self, fut):
        with self._lock:
            return fut.result()  # PLANTED JL303

    def planted_write(self):
        self._planted_state = 2
'''
_JL501 = '''

def planted_order(items, out):
    for k in set(items):  # PLANTED JL501
        out.append(k)
'''


def test_planted_violations_in_a_port_module_are_flagged(tmp_path):
    src = (PORT / "service" / "server.py").read_text()
    lines = src.splitlines(keepends=True)
    # JL301: the worker loop and a new public (client-root) method of
    # TallyService both write one attribute, unlocked.
    loop = next(i for i, ln in enumerate(lines)
                if ln.startswith("    def _worker_loop(self)"))
    assert lines[loop].rstrip().endswith(":")
    lines.insert(loop + 1, _JL301)
    # JL303: a future waited on under the service's lock; the client
    # root's write goes in beside it, at the end of TallyService.
    cls = next(i for i, ln in enumerate(lines)
               if ln.startswith("class TallyService"))
    end = next(i for i in range(cls + 1, len(lines))
               if lines[i].startswith(("class ", "def ", "@")))
    while not lines[end - 1].strip():
        end -= 1
    lines.insert(end, _JL303)
    planted = tmp_path / "server.py"
    planted.write_text("".join(lines) + _JL501)
    assert lint_paths([str(PORT / "service" / "server.py")]) == []
    diags = lint_paths([str(planted)])
    text = planted.read_text().splitlines()
    got = sorted((d.rule, text[d.line - 1].strip()) for d in diags)
    # JL301 flags each unlocked write of the attribute, one a root.
    assert got == [
        ("JL301", _JL301.strip()),
        ("JL301", "self._planted_state = 2"),
        ("JL303", "return fut.result()  # PLANTED JL303"),
        ("JL501", "for k in set(items):  # PLANTED JL501"),
    ]
