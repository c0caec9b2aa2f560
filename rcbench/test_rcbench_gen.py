"""The frozen traffic generator repeats exactly for a seed, and an open
loop sends the same set of gaps on every seed."""
import numpy as np

from rcbench import cell as C
from rcbench import gen


def _traffic():
    tr = C.read_json(C.HERE / "traffic" / "rank_open.json")
    tr["world"].update(n_items=60, history_requests=30, history_users=8)
    tr["requests"].update(n_users=50)
    return tr


def _digest(w):
    parts = [w.instruction, w.catalog.popularity, *w.catalog.item_tokens, *w.corpus]
    for r in w.requests:
        parts += [r.history_tokens, r.history_marker_mask.astype(np.int32), r.candidate_items]
    return [np.asarray(p).tobytes() for p in parts] + [w.lsh_seed]


def test_world_repeats_exactly_for_a_seed_and_differs_across_seeds():
    tr = _traffic()
    a, b = gen.world(tr, 2 ** 33 + 5, 12), gen.world(tr, 2 ** 33 + 5, 12)
    assert _digest(a) == _digest(b)
    assert _digest(a) != _digest(gen.world(tr, 7, 12))


def test_request_stream_is_a_prefix_of_a_longer_one():
    tr = _traffic()
    short, long = gen.world(tr, 11, 5), gen.world(tr, 11, 9)
    for x, y in zip(short.requests, long.requests):
        assert np.array_equal(x.candidate_items, y.candidate_items)
        assert np.array_equal(x.history_tokens, y.history_tokens)


def test_prompts_have_the_profile_shape():
    tr = C.read_json(C.HERE / "traffic" / "rank_open.json")
    tr["world"].update(history_requests=20)
    tr["requests"].update(n_users=30)
    w = gen.world(tr, 3, 6)
    for r in w.requests:
        toks, kind, _ = r.prompt_segments(w.catalog, w.instruction)
        assert (kind == 2).sum() > 20 * 60          # 20 items of ~88 tokens
        assert len(r.candidate_items) == 20 and len(set(r.candidate_items)) == 20
        assert toks.max() < tr["world"]["vocab_size"]


def test_open_loop_gaps_are_the_same_set_on_every_seed():
    a, b = gen.arrival_gaps(400, 6.0, 1), gen.arrival_gaps(400, 6.0, 99)
    assert not np.array_equal(a, b)
    assert np.array_equal(np.sort(a), np.sort(b))
    assert abs(a.mean() - 1 / 6.0) < 0.01
    d = gen.due_times(40.0, 6.0, 5)
    assert np.all(np.diff(d) > 0) and d[-1] < 40.0 and abs(len(d) - 240) <= 2
    assert np.array_equal(d, gen.due_times(40.0, 6.0, 5))
