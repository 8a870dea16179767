"""Whether the served replies are right: each reply, decrypted by the
benchmark's own client (portbench.reference), must carry the item stored
at the index its query asked for.

Equal Responses to one pool request (protobuf message equality) are
decrypted once and counted for each time they were served; a Response that
differs is decrypted on its own.  Every number compared is a count of
replies, with limit 0.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from portbench.reference import wire

MAX_JUDGED_REPLIES = 8192  # beyond this many distinct replies, a sample drawn from the seed
DECRYPT_STACK = 256  # replies decrypted in one stack
LIMITS = {"wrong_replies": 0, "missing_replies": 0}


def cut_to_plaintext_bits(reply: np.ndarray, ct_moduli, t: int) -> np.ndarray:
    """The control: every word of a reply u64[k, size, l, N] keeps only its
    top bit_length(t) bits, as a reply sent at the plaintext's precision
    would.  It breaks exact retrieval."""
    out = reply.copy()
    for i in range(reply.shape[-2]):
        cut = np.uint64(max(0, int(ct_moduli[i]).bit_length() - int(t).bit_length()))
        out[..., i, :] = (out[..., i, :] >> cut) << cut
    return out


def judge(served, pool, clients, items: np.ndarray, rng: np.random.Generator,
          control: bool = False) -> "tuple[dict, set, int]":
    """(checks {name: count}, positions in `served` of the requests with a
    wrong or missing reply, replies decrypted).  `served`: traffic.Served
    in order; `items`: uint8[num_items, item_bytes]."""
    counts = {"wrong_replies": 0, "missing_replies": 0}
    failed: set = set()
    distinct: dict = {}  # (pool index, j) -> (its j-th distinct Response, positions)
    for k, s in enumerate(served):
        if s.response is None:
            counts["missing_replies"] += len(pool[s.pool_index].indexes)
            failed.add(k)
            continue
        j = 0
        while (s.pool_index, j) in distinct and distinct[(s.pool_index, j)][0] != s.response:
            j += 1
        distinct.setdefault((s.pool_index, j), (s.response, []))[1].append(k)

    keys = list(distinct)
    sizes = [len(pool[i].indexes) for i, _ in keys]
    if sum(sizes) > MAX_JUDGED_REPLIES:
        order = rng.permutation(len(keys))
        keep, total = [], 0
        for j in order:
            if total + sizes[j] > MAX_JUDGED_REPLIES:
                break
            keep.append(keys[j])
            total += sizes[j]
        keys = keep

    queued = defaultdict(list)  # (client, reply shape) -> [(reply, index, key)]
    bad: dict = defaultdict(int)  # key -> wrong or missing replies in its Response
    for key in keys:
        req = pool[key[0]]
        client = clients[req.client]
        replies = wire.response_replies(distinct[key][0].SerializeToString())
        want = client.expected_reply_shape()
        bad[key] += max(0, len(req.indexes) - len(replies))
        counts["missing_replies"] += max(0, len(req.indexes) - len(replies)) * len(distinct[key][1])
        extra = max(0, len(replies) - len(req.indexes))
        counts["wrong_replies"] += extra * len(distinct[key][1])
        bad[key] += extra
        for reply, index in zip(replies, req.indexes):
            if reply is None or reply.shape[:2] != want or reply.shape[-1] != client.params.n:
                counts["wrong_replies"] += len(distinct[key][1])
                bad[key] += 1
                continue
            if control:
                reply = cut_to_plaintext_bits(reply, client.params.ct_moduli, client.params.t)
            queued[(req.client, reply.shape)].append((reply, index, key))

    judged = 0
    for (c, _), entries in queued.items():
        for s0 in range(0, len(entries), DECRYPT_STACK):
            chunk = entries[s0: s0 + DECRYPT_STACK]
            got = clients[c].items(np.stack([e[0] for e in chunk]), [e[1] for e in chunk])
            judged += len(chunk)
            for item, (_, index, key) in zip(got, chunk):
                if item != items[index].tobytes():
                    counts["wrong_replies"] += len(distinct[key][1])
                    bad[key] += 1
    for key, n in bad.items():
        if n:
            failed.update(distinct[key][1])
    return counts, failed, judged
