"""The frozen client (portbench.reference) against the program: requests it
makes are served by pir_tpu_torch.PirServer on the CPU and decrypt, in the
frozen client, to the items asked for; a corrupted reply is judged wrong;
the batched scale-and-round equals exact integer arithmetic."""

import numpy as np
import pytest
import torch

import pir_tpu_torch as pt
from pir_tpu_torch.proto import payload_pb2 as pb
from portbench import judge, traffic
from portbench.reference import bfv, wire
from portbench.reference import params as rp
from portbench.reference.client import Client
from tiny import TINY


def _stack(mode):
    cfg = dict(TINY, mode=mode)
    rparams = rp.from_config(cfg)
    ep = pt.EncryptionParams(cfg["poly_modulus_degree"], cfg["plain_modulus"],
                             tuple(cfg["coeff_modulus"]))
    params = pt.create_pir_parameters(cfg["items"], cfg["item_bytes"], cfg["dimensions"], ep,
                                      use_ciphertext_multiplication=mode != "decomposition")
    items = np.random.default_rng(5).integers(0, 256, (cfg["items"], cfg["item_bytes"]), dtype=np.uint8)
    db = pt.PirDatabase.create([r.tobytes() for r in items], params, device="cpu")
    server = pt.PirServer(db, params, reply_limbs=pt.reply_limbs_for(params))
    client = Client(bfv.Context(rparams, "cpu"), np.random.default_rng(6))
    return rparams, params, items, server, client


@pytest.mark.parametrize("mode", ["decomposition", "ciphertext_multiplication"])
@pytest.mark.parametrize("indexes", [[0], [7, 199, 55, 100]])
def test_served_requests_decrypt_to_their_items(mode, indexes):
    rparams, params, items, server, client = _stack(mode)
    assert (rparams.dimensions, rparams.num_pt) == (tuple(params.dimensions), params.num_pt)
    data = client.requests([indexes])[0]
    response = server.process_request(pb.Request.FromString(data)).SerializeToString()
    replies = wire.response_replies(response)
    assert [r.shape[:2] for r in replies] == [client.expected_reply_shape()] * len(indexes)
    assert client.items(np.stack(replies), indexes) == [items[i].tobytes() for i in indexes]


@pytest.mark.parametrize("where", ["low", "high"])
def test_a_corrupted_reply_word_is_judged_wrong(where):
    rparams, _, items, server, client = _stack("decomposition")
    indexes = [3, 150]
    req = traffic.Request(0, indexes, client.requests([indexes])[0])
    response = server.process_request(pb.Request.FromString(req.data))
    sound = traffic.Served(0, 0.0, 1.0, response)
    counts, failed, _ = judge.judge([sound], [req], [client], items, np.random.default_rng(0))
    assert counts == {"wrong_replies": 0, "missing_replies": 0} and not failed

    # one word of the second reply, moved by a quarter of its modulus
    bad = pb.Response.FromString(response.SerializeToString())
    arr = wire.unpack_array(bad.reply[1].ct[0]).copy()
    q = rparams.ct_moduli[0]
    n = 0 if where == "low" else arr.shape[-1] - 1
    arr[1, 0, n] = (int(arr[1, 0, n]) + q // 4) % q
    bad.reply[1].ct[0] = wire.pack_array(arr)
    counts, failed, _ = judge.judge([traffic.Served(0, 0.0, 1.0, bad)], [req], [client], items,
                                    np.random.default_rng(0))
    assert counts == {"wrong_replies": 1, "missing_replies": 0} and failed == {0}


def test_a_short_response_is_missing_replies():
    _, _, items, server, client = _stack("decomposition")
    req = traffic.Request(0, [1, 2, 3, 4], client.requests([[1, 2, 3, 4]])[0])
    response = server.process_request(pb.Request.FromString(req.data))
    del response.reply[2:]
    counts, failed, _ = judge.judge([traffic.Served(0, 0.0, 1.0, response),
                                     traffic.Served(0, 0.0, None, None)], [req], [client], items,
                                    np.random.default_rng(0))
    assert counts == {"wrong_replies": 0, "missing_replies": 2 + 4} and failed == {0, 1}


def _exact(x_limbs, moduli, t):
    q = 1
    for m in moduli:
        q *= m
    x = 0
    for xi, m in zip(x_limbs, moduli):
        x += xi * pow(q // m, -1, m) % m * (q // m)
    x %= q
    return ((t * x + (q >> 1)) // q) % t


@pytest.mark.parametrize("level", [1, 2, 4])
def test_scale_round_is_exact(level):
    cfg = dict(TINY, poly_modulus_degree=8192, plain_modulus=16760833, plain_modulus_bits=24,
               coeff_modulus=[8796092858369, 8796092792833, 17592186028033, 17592185438209,
                              17592184717313])
    ctx = bfv.Context(rp.from_config(cfg), "cpu")
    moduli = ctx.ct_moduli[:level]
    rng = np.random.default_rng(level)
    x = np.stack([rng.integers(0, m, size=(3, 64), dtype=np.uint64) for m in moduli], axis=-2)
    # coefficients on a rounding edge: t x / q = k + 1/2 exactly needs q even, so take
    # the nearest words, x = (q (2k + 1) / (2t)) rounded both ways
    q = 1
    for m in moduli:
        q *= m
    for j, k in enumerate([0, 1, ctx.t // 2, ctx.t - 1]):
        for side, col in ((0, 2 * j), (1, 2 * j + 1)):
            v = (q * (2 * k + 1)) // (2 * ctx.t) + side
            x[0, :, col] = [v % m for m in moduli]
    got = bfv.scale_round(ctx, torch.from_numpy(x.view(np.int64)))
    want = [[_exact([int(x[b, i, c]) for i in range(level)], moduli, ctx.t) for c in range(64)]
            for b in range(3)]
    assert got.tolist() == want


def test_too_many_distinct_replies_are_sampled(monkeypatch):
    _, _, items, server, client = _stack("decomposition")
    pool = [traffic.Request(0, [i, i + 1], client.requests([[i, i + 1]])[0]) for i in range(4)]
    served = [traffic.Served(k, 0.0, 1.0, server.process_request(pb.Request.FromString(r.data)))
              for k, r in enumerate(pool)]
    monkeypatch.setattr(judge, "MAX_JUDGED_REPLIES", 5)
    counts, failed, judged = judge.judge(served, pool, [client], items, np.random.default_rng(1))
    assert judged == 4 and counts == {"wrong_replies": 0, "missing_replies": 0} and not failed
