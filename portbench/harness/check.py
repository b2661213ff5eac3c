"""Whether what the timed path served is right: a sample of the requests
it finished, drawn from the seed, each run once through the plain fp32
reference over its prompt and served tokens, and the gaps by which the
served tokens' logits lie below the reference's best at their positions.
The configuration file names which of them are compared and their
limits.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def pick_sample(finished: Sequence, seed: int, *, target_tokens: int,
                max_requests: int, in_flight: Sequence = ()) -> List:
    """Requests to check: the one with the most served tokens, one that
    decoded on the host tier and one later turn of a session (where the
    run has them), then others drawn from the seed until
    ``target_tokens`` served tokens or ``max_requests``.  A host row
    takes num_layers + 1 iterations a token, so its requests rarely
    finish in a run: where no finished one decoded on the host, the
    tokens served so far of one still in flight stand in."""
    done = [t for t in finished if not t.req.failed and t.req.output]
    if not done or max_requests <= 0:
        return []
    chosen = [max(done, key=lambda t: (len(t.req.output), t.req.prompt_len))]
    rng = np.random.default_rng([int(seed) % (1 << 63), 0xC4EC])
    host_done = [t for t in done if t.host and t not in chosen]
    host_live = [t for t in in_flight if t.host and len(t.req.output) >= 2]
    for pool in (host_done or host_live,
                 [t for t in done if t.turn > 0 and t not in chosen]):
        if pool:
            chosen.append(pool[int(rng.integers(len(pool)))])
    rest = [t for t in done if t not in chosen]
    for i in rng.permutation(len(rest)):
        if len(chosen) >= max_requests or \
                sum(len(t.req.output) for t in chosen) >= target_tokens:
            break
        chosen.append(rest[int(i)])
    return chosen


def served(tracks: Sequence) -> List[Dict[str, list]]:
    """Each request's prompt and served tokens as plain lists (of one
    still in flight, the tokens served so far)."""
    return [{"prompt": list(map(int, t.req.prompt)),
             "output": [int(x) for x in list(t.req.output)],
             "host": bool(t.host), "turn": int(t.turn)} for t in tracks]


def positions(sample: Sequence[dict]):
    """(sequences, wanted positions): the served token j of a request is
    predicted at position len(prompt) + j - 1 of prompt + output[:-1]."""
    seqs, wanted = [], []
    for s in sample:
        p = len(s["prompt"])
        seqs.append(s["prompt"] + s["output"][:-1])
        wanted.append(list(range(p - 1, p - 1 + len(s["output"]))))
    return seqs, wanted


def gaps(ref_logits, tokens: Sequence[Sequence[int]]) -> dict:
    """Over every position: the reference's best logit minus its logit of
    the token given there.  Returns the widest such gap, the mean gap and
    the share of positions where the token given is not the reference's
    best."""
    import torch
    all_gaps = []
    for lg, toks in zip(ref_logits, tokens):
        idx = torch.as_tensor(list(toks), device=lg.device)
        all_gaps.append(lg.max(-1).values - lg.gather(-1, idx[:, None])[:, 0])
    if not all_gaps:
        return {"widest_logit_gap": 0.0, "mean_logit_gap": 0.0,
                "off_best_pct": 0.0}
    g = torch.cat(all_gaps).double()
    return {"widest_logit_gap": float(g.max()),
            "mean_logit_gap": float(g.mean()),
            "off_best_pct": 100.0 * float((g > 0).double().mean())}


def judge(check_cfg: dict, reading: dict) -> Tuple[dict, bool]:
    """Each number that ``checks/<cell>.json`` compares, beside its limit,
    and whether the reading passes: every such number at or under its
    limit, over at least ``min_tokens`` served tokens.  The program's
    reading and the control's are judged alike."""
    checks = {name: {"value": reading[name], "limit": limit}
              for name, limit in check_cfg["limits"].items()}
    checks["served_tokens_at_least"] = {
        "value": reading["tokens"],
        "limit": int(check_cfg.get("min_tokens", 1))}
    ok = all(checks[n]["value"] <= checks[n]["limit"]
             for n in check_cfg["limits"]) and \
        reading["tokens"] >= checks["served_tokens_at_least"]["limit"]
    return checks, ok


def check_sample(cfg: dict, weights: dict, sample: Sequence[dict]) -> dict:
    """The reference over the sample: the gaps of the served tokens and
    how many were compared."""
    from portbench.reference.model import logits_at
    seqs, wanted = positions(sample)
    ref = logits_at(cfg, weights, seqs, wanted)
    out = gaps(ref, [s["output"] for s in sample])
    out.update(tokens=sum(len(s["output"]) for s in sample),
               requests=len(sample))
    return out


def control_gap(cfg: dict, weights: dict, sample: Sequence[dict],
                precision: str = "int8") -> dict:
    """The control: the reference in a lower precision put in the
    program's place.  At each position of the same prompts and tokens,
    the gap (under fp32) of the token the lower precision puts first."""
    from portbench.reference.model import logits_at
    seqs, wanted = positions(sample)
    ref = logits_at(cfg, weights, seqs, wanted)
    low = logits_at(cfg, weights, seqs, wanted, precision=precision)
    picks = [lg.argmax(-1).tolist() for lg in low]
    tokens = sum(len(s["output"]) for s in sample)
    return {"control": dict(gaps(ref, picks), tokens=tokens),
            "served": dict(gaps(ref, [s["output"] for s in sample]),
                           tokens=tokens),
            "tokens": tokens}
