"""The LoD ``beam_search`` / ``beam_search_decode`` ops of the port.

- The reference's fixtures (``tests/test_beam_search_lod.py``, lifted
  from the reference's ``test_beam_search_op.py`` and
  ``test_beam_search_decode_op.py``) through both packages: ids, LoDs
  and parent indices equal, scores bitwise.
- Under a two-level LoD whose level 1 holds more than one row a prefix
  (every step after the first of a beam-search ``While`` loop), the
  candidates of source i are the rows its level-0 entry names in
  *absolute* offsets (the reference's ``ToAbsOffset``): the port selects
  as a numpy oracle of that rule does, the JAX package (which reads level
  0 as rows) groups other rows, and its output LoD no longer covers the
  rows. On one-row-a-prefix LoDs the two agree (the fixtures above).
- The layers build the JAX package's ops, slots and attrs.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid

PACKAGES = {"jax": jfluid, "port": fluid}


def set_lod_tensor(scope, name, data, dtype, lod=None):
    t = scope.var(name).get_tensor()
    t.set(np.array(data, dtype))
    if lod:
        t._lod = [list(level) for level in lod]


def beam_search_step(pkg, ids, scores, pre_ids, pre_scores, lod, beam,
                     end_id=0, accumulated=True):
    prog = pkg.Program()
    blk = prog.global_block()
    for n, dt in [("pre_ids", "int64"), ("pre_scores", "float32"),
                  ("ids", "int64"), ("scores", "float32"),
                  ("selected_ids", "int64"), ("selected_scores", "float32"),
                  ("parent_idx", "int32")]:
        # persistable: read back from the scope after the run
        blk.create_var(name=n, dtype=dt, persistable=True)
    blk.append_op("beam_search",
                  inputs={"pre_ids": ["pre_ids"],
                          "pre_scores": ["pre_scores"], "ids": ["ids"],
                          "scores": ["scores"]},
                  outputs={"selected_ids": ["selected_ids"],
                           "selected_scores": ["selected_scores"],
                           "parent_idx": ["parent_idx"]},
                  attrs={"level": 0, "beam_size": beam, "end_id": end_id,
                         "is_accumulated": accumulated},
                  infer_shape=False)
    scope = pkg.Scope()
    set_lod_tensor(scope, "pre_ids", pre_ids, "int64")
    set_lod_tensor(scope, "pre_scores", pre_scores, "float32")
    set_lod_tensor(scope, "ids", ids, "int64", lod)
    set_lod_tensor(scope, "scores", scores, "float32", lod)
    with pkg.scope_guard(scope):
        pkg.Executor(pkg.CPUPlace()).run(prog, fetch_list=[])
    si = scope.find_var("selected_ids").get_tensor()
    ss = scope.find_var("selected_scores").get_tensor()
    parent = np.asarray(scope.find_var("parent_idx").get_tensor())
    return (np.asarray(si).reshape(-1), np.asarray(ss).reshape(-1),
            si.lod(), ss.lod(), parent)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_beam_search_reference_fixture(pkg):
    ids, scores, lod, slod, parent = beam_search_step(
        PACKAGES[pkg], ids=[[4, 2, 5], [2, 1, 3], [3, 5, 2], [8, 2, 1]],
        scores=[[0.5, 0.3, 0.2], [0.6, 0.3, 0.1], [0.9, 0.5, 0.1],
                [0.7, 0.5, 0.1]],
        pre_ids=[[1, 2, 3, 4]], pre_scores=[[0.1, 0.2, 0.3, 0.4]],
        lod=[[0, 2, 4], [0, 1, 2, 3, 4]], beam=2)
    np.testing.assert_array_equal(ids, [4, 2, 3, 8])
    np.testing.assert_array_equal(scores, np.float32([0.5, 0.6, 0.9, 0.7]))
    assert lod == slod == [[0, 2, 4], [0, 1, 2, 3, 4]]
    np.testing.assert_array_equal(parent, [0, 1, 2, 3])


def decode(pkg, steps, beam, end_id):
    prog = pkg.Program()
    blk = prog.global_block()
    blk.create_var(name="ids")
    blk.create_var(name="scores")
    blk.create_var(name="sentence_ids", dtype="int64", persistable=True)
    blk.create_var(name="sentence_scores", dtype="float32",
                   persistable=True)
    blk.append_op("beam_search_decode",
                  inputs={"Ids": ["ids"], "Scores": ["scores"]},
                  outputs={"SentenceIds": ["sentence_ids"],
                           "SentenceScores": ["sentence_scores"]},
                  attrs={"beam_size": beam, "end_id": end_id},
                  infer_shape=False)
    scope = pkg.Scope()
    ids_arr = scope.var("ids").get_lod_tensor_array()
    scores_arr = scope.var("scores").get_lod_tensor_array()
    for lod, data in steps:
        for arr, dt in ((ids_arr, "int64"), (scores_arr, "float32")):
            t = pkg.LoDTensor()
            t.set(np.array(data, dt))
            t._lod = [list(level) for level in lod]
            arr.append(t)
    with pkg.scope_guard(scope):
        pkg.Executor(pkg.CPUPlace()).run(prog, fetch_list=[])
    si = scope.find_var("sentence_ids").get_tensor()
    ss = scope.find_var("sentence_scores").get_tensor()
    return (np.asarray(si).reshape(-1), np.asarray(ss).reshape(-1),
            si.lod(), ss.lod())


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_beam_search_decode_reference_fixture(pkg):
    steps = [
        ([[0, 1, 2], [0, 1, 2]], [0, 0]),
        ([[0, 1, 2], [0, 2, 4]], [2, 3, 4, 5]),
        ([[0, 2, 4], [0, 2, 2, 4, 4]], [3, 1, 5, 4]),
        ([[0, 2, 4], [0, 1, 2, 3, 4]], [1, 1, 3, 5]),
        ([[0, 2, 4], [0, 0, 0, 2, 2]], [5, 1]),
    ]
    ids, scores, lod, slod = decode(PACKAGES[pkg], steps, beam=2, end_id=1)
    expected = np.array(
        [0, 2, 3, 1, 0, 2, 1, 0, 4, 5, 3, 5, 0, 4, 5, 3, 1], "int64")
    assert lod == slod == [[0, 2, 4], [0, 4, 7, 12, 17]]
    np.testing.assert_array_equal(ids, expected)
    np.testing.assert_array_equal(scores, expected.astype("float32"))


def select_oracle(ids, scores, pre_ids, pre_scores, lod, beam, end_id):
    """The reference's selection, written from its rule: source i's rows
    are its absolute row range; a finished row offers (end_id, its
    score); the best ``beam`` by score (ties to the lower row) are kept,
    a source whose items and rows all ended is dropped; items are
    emitted row by row. Returns (ids, scores, LoD, parents)."""
    ids, scores = np.asarray(ids), np.asarray(scores, "float32")
    pre_ids = np.asarray(pre_ids).reshape(-1)
    pre_scores = np.asarray(pre_scores, "float32").reshape(-1)
    rows_of = [lod[1][o] for o in lod[0]]
    chosen = []
    for s in range(len(rows_of) - 1):
        items = []
        for r in range(rows_of[s], rows_of[s + 1]):
            if pre_ids[r] == end_id:
                items.append((-pre_scores[r], r, end_id))
            else:
                items += [(-scores[r, k], r, ids[r, k])
                          for k in range(ids.shape[1])]
        best = sorted(items, key=lambda it: (it[0], it[1]))[:beam]
        if not all(tok == end_id and pre_ids[r] == end_id
                   for _, r, tok in best):
            chosen += best
    chosen.sort(key=lambda it: it[1])  # stable: a row keeps its order
    low = [0]
    for r in range(rows_of[-1]):
        low.append(low[-1] + sum(1 for it in chosen if it[1] == r))
    return (np.array([it[2] for it in chosen]),
            np.array([-it[0] for it in chosen], "float32"),
            [rows_of, low], np.array([it[1] for it in chosen]))


def test_a_two_level_lod_selects_by_absolute_rows():
    """Two sources with one prefix each at the step before and two live
    rows each now (LoD [[0, 1, 2], [0, 2, 4]]), beam 2, one row ended:
    the port selects as the oracle; the JAX package gives source 1 a row
    of source 0 and a LoD whose level 0 ends at 2 rows of the 4."""
    lod = [[0, 1, 2], [0, 2, 4]]
    case = dict(ids=[[11, 12], [13, 14], [15, 16], [17, 18]],
                scores=[[-1.5, -2.5], [-1.0, -3.0], [-0.5, -0.5],
                        [-4.0, -4.5]],
                pre_ids=[[5], [6], [0], [8]],
                pre_scores=[[-1.0], [-2.0], [-0.75], [-4.0]], lod=lod)
    want = select_oracle(beam=2, end_id=0, **case)
    got = beam_search_step(fluid, beam=2, **case)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], [11, 13, 0, 17])
    assert got[2] == got[3] == want[2] == [[0, 2, 4], [0, 1, 2, 3, 4]]
    np.testing.assert_array_equal(got[4], want[3])
    j = beam_search_step(jfluid, beam=2, **case)
    assert j[2][0] == [0, 1, 2] and j[2][1][-1] == len(j[0])
    assert not np.array_equal(j[0], want[0])


def test_a_pruned_source_ends_once_written():
    """Every row of source 0 ended and its best items are end ids: it is
    dropped (no rows of it selected); source 1 goes on."""
    lod = [[0, 1, 2], [0, 2, 4]]
    case = dict(ids=[[3, 4], [5, 6], [7, 8], [9, 10]],
                scores=[[-1.0, -2.0], [-1.5, -2.5], [-0.5, -0.7],
                        [-0.6, -0.8]],
                pre_ids=[[0], [0], [2], [3]],
                pre_scores=[[-1.0], [-1.25], [-3.0], [-3.5]], lod=lod)
    got = beam_search_step(fluid, beam=2, end_id=0, **case)
    want = select_oracle(beam=2, end_id=0, **case)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], [7, 9])
    assert got[2] == want[2] == [[0, 2, 4], [0, 0, 0, 1, 2]]


def layer_ops(pkg):
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        pre_ids = L.data(name="pre_ids", shape=[1], dtype="int64",
                         lod_level=2)
        pre_scores = L.data(name="pre_scores", shape=[1], dtype="float32",
                            lod_level=2)
        scores = L.data(name="scores", shape=[3], dtype="float32",
                        lod_level=2)
        ids = L.data(name="ids", shape=[3], dtype="int64", lod_level=2)
        sel_ids, sel_scores, _ = L.beam_search(
            pre_ids, pre_scores, ids, scores, 3, end_id=1,
            return_parent_idx=True)
        ids_arr = L.array_write(sel_ids, L.zeros([1], "int64"))
        scores_arr = L.array_write(sel_scores, L.zeros([1], "int64"))
        L.beam_search_decode(ids_arr, scores_arr, 3, end_id=1)
        sel_ids.shape = (-1, 1)  # the layer leaves it unset
        L.is_empty(sel_ids)
    return [(op.type, op.inputs, op.outputs, cast_attrs(op))
            for op in main.global_block().ops]


def cast_attrs(op):
    """The op's attrs; a ``cast`` from int64 reads int32 (2) in the JAX
    package (x64 off), 3 in the port."""
    attrs = dict(op.attrs)
    if op.type == "cast" and attrs.get("in_dtype") == 2:
        attrs["in_dtype"] = 3
    return attrs


def test_the_layers_build_the_jax_packages_ops():
    assert layer_ops(fluid) == layer_ops(jfluid)

