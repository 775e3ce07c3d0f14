"""The port's access trace (``repro_torch.core.on_demand.AccessTrace``) against
the reference's schema v3: the same ``record`` / ``record_request`` /
``end_request`` stream gives the same ``to_dict()`` and JSON in both packages
(batches over both association caps included), a trace saved by either
package loads in the other, ``merge`` and ``merge_all`` give the same
documents, v1 and v2 documents load as the reference loads them, and both
refuse the same bad inputs."""

import json

import numpy as np
import pytest

from repro.core.on_demand import AccessTrace as RefTrace
from repro_torch.core.on_demand import AccessTrace

KEYS = [f"u{i}" for i in range(12)]
PHASES = ["prefill", "decode", ""]


def _stream(seed: int, n: int = 40) -> list:
    """A seeded access script: demand batches of 1..12 keys (over the
    second-order cap of 8, and over a small first-order cap), some repeated
    keys, per-request records and retirements."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        kind = rng.integers(0, 4)
        if kind < 2:
            size = int(rng.choice([1, 1, 2, 2, 3, 5, 9, 12]))
            keys = [KEYS[i] for i in rng.integers(0, len(KEYS), size)]
            cold = [k for k in keys if rng.random() < 0.4]
            ops.append(("record", keys, cold, PHASES[int(rng.integers(0, 3))]))
        elif kind == 2:
            keys = [KEYS[i] for i in rng.integers(0, len(KEYS), int(rng.integers(0, 6)))]
            ops.append(("record_request", int(rng.integers(0, 3)), keys))
        else:
            ops.append(("end_request", int(rng.integers(0, 3))))
    return ops


def _play(trace, ops):
    for op, *args in ops:
        getattr(trace, op)(*args)
    return trace


@pytest.mark.parametrize("caps", [{}, {"max_assoc_batch": 6, "max_order2_batch": 3}], ids=["default", "tight"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_stream_same_document(seed, caps):
    ops = _stream(seed)
    ref, port = _play(RefTrace(**caps), ops), _play(AccessTrace(**caps), ops)
    assert port.to_dict() == ref.to_dict()
    assert port.to_json() == ref.to_json()
    doc = port.to_dict()
    assert doc["version"] == 3 and doc["transitions2"] and doc["phase_transitions"]
    # no empty successor dict anywhere
    for tbl in [doc["transitions"], doc["request_transitions"], *doc["phase_transitions"].values()]:
        assert all(tbl.values())


def test_tables_follow_the_reference_caps():
    """A batch over the first-order cap resets both chains; one over the
    second-order cap records first-order transitions only."""
    big, small = KEYS[:9], KEYS[9:11]
    for cls in (RefTrace, AccessTrace):
        t = cls()
        t.record(["u0"], [], "prefill")
        t.record(["u1"], [], "decode")
        t.record(big, [], "decode")  # 9 > 8: no second-order rows
        assert not any(a1 in big or b in big for (a2, a1), v in t.transitions2.items() for b in v)
        t.record(small, [], "decode")  # previous batch over cap 8: still none
        assert all(a2 not in big for a2, _ in t.transitions2)
        t2 = cls(max_assoc_batch=4)
        t2.record(["u0"], [], "")
        t2.record(big, big, "")  # over the first-order cap: chains reset
        t2.record(["u1"], [], "")
        assert t2.transitions == {} and t2.transitions2 == {}
    ops = [("record", ["u0"], [], "prefill"), ("record", ["u1"], [], "decode"), ("record", big, [], "decode"),
           ("record", small, [], "decode"), ("record", ["u2", "u2"], ["u2"], "decode")]
    assert _play(AccessTrace(), ops).to_dict() == _play(RefTrace(), ops).to_dict()


@pytest.mark.parametrize("writer,reader", [(RefTrace, AccessTrace), (AccessTrace, RefTrace)],
                         ids=["ref-to-port", "port-to-ref"])
def test_saved_trace_loads_in_the_other_package(tmp_path, writer, reader):
    path = str(tmp_path / "trace.json")
    src = _play(writer(), _stream(3))
    src.save(path)
    loaded = reader.load(path)
    assert loaded.to_dict() == src.to_dict()
    again = str(tmp_path / "again.json")
    loaded.save(again)
    assert open(again).read() == open(path).read()  # save → load → save is byte-identical
    assert reader.from_json(src.to_json()).to_json() == src.to_json()


@pytest.mark.parametrize("decay,prune", [(1.0, 0.5), (0.5, 0.5), (0.0, 0.5), (0.3, 1.0)])
def test_merge_matches_reference(decay, prune):
    a_ops, b_ops = _stream(4), _stream(5)
    ref = _play(RefTrace(), a_ops).merge(_play(RefTrace(), b_ops), decay=decay, prune_below=prune)
    port = _play(AccessTrace(), a_ops).merge(_play(AccessTrace(), b_ops), decay=decay, prune_below=prune)
    assert port.to_json() == ref.to_json()
    # merged counts of one package load in the other, floats included
    assert AccessTrace.from_json(ref.to_json()).to_json() == ref.to_json()
    assert RefTrace.from_json(port.to_json()).to_json() == port.to_json()


def test_merge_all_matches_reference_in_any_order():
    windows = [_stream(s, 15) for s in (6, 7, 8)]
    want = RefTrace.merge_all([_play(RefTrace(), w) for w in windows])
    for order in ([0, 1, 2], [2, 0, 1]):
        got = AccessTrace.merge_all([_play(AccessTrace(), windows[i]) for i in order])
        assert got.to_json() == want.to_json()
    assert AccessTrace.merge_all([]).to_dict() == RefTrace.merge_all([]).to_dict()


@pytest.mark.parametrize("version", [1, 2])
def test_older_documents_load_as_in_the_reference(version):
    doc = _play(RefTrace(), _stream(9)).to_dict()
    old = {k: v for k, v in doc.items() if k not in ("phase_transitions", "transitions2")}
    if version == 1:
        old = {k: v for k, v in old.items() if k not in ("request_pairs", "request_transitions")}
    old["version"] = version
    assert AccessTrace.from_dict(old).to_dict() == RefTrace.from_dict(old).to_dict()


def test_bad_inputs_raise_as_in_the_reference():
    for cls in (RefTrace, AccessTrace):
        t = _play(cls(), _stream(10, 5))
        with pytest.raises(ValueError, match="itself"):
            t.merge(t)
        with pytest.raises(ValueError, match="decay"):
            t.merge(cls(), decay=1.5)
        other = cls()
        other.version = 2
        with pytest.raises(ValueError, match="schema"):
            t.merge(other)
        with pytest.raises(ValueError, match="unsupported"):
            cls.from_dict({"version": 99})
        with pytest.raises(json.JSONDecodeError):
            cls.from_json("not json")
