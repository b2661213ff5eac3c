"""Minimal blocking HTTP/SSE client for the gateway wire format.

Shared by the tests, ``chip_smoke.py``'s gateway phase and the CLI
``--smoke-test`` so they all parse the same frames a real client
would.  Uses stdlib ``http.client``; the gateway's ``Connection:
close`` framing means the SSE body is EOF-terminated.  The port keeps
its own copy of ``repro/serving/gateway/client.py``.
"""
from __future__ import annotations

import http.client
import json
import time
from typing import Any, Dict, List, Optional


def get_json(host: str, port: int, path: str, *,
             timeout: float = 30.0) -> Dict[str, Any]:
    """GET a JSON endpoint; returns {"status": int, "body": parsed}."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        raw = resp.read()
        try:
            body = json.loads(raw.decode() or "null")
        except json.JSONDecodeError:
            body = raw.decode(errors="replace")
        return {"status": resp.status, "body": body}
    finally:
        conn.close()


def get_text(host: str, port: int, path: str, *,
             timeout: float = 30.0) -> Dict[str, Any]:
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return {"status": resp.status,
                "body": resp.read().decode(errors="replace")}
    finally:
        conn.close()


def sse_chat(host: str, port: int, prompt: List[int], *,
             max_new_tokens: Optional[int] = None,
             deadline: Optional[float] = None, priority: int = 0,
             session_id: Optional[str] = None,
             timeout: float = 120.0) -> Dict[str, Any]:
    """POST /v1/chat and consume the SSE stream to completion.

    Returns::

        {"status": 200, "tokens": [...], "error": None,
         "ttft_s": 0.01,          # first token (client clock)
         "itl_s": [...],          # inter-token gaps (client clock)
         "done": {...}}           # the terminal event's payload

    Shed responses come back as {"status": 429|503, "body": {...}}.
    """
    payload: Dict[str, Any] = {"prompt": list(map(int, prompt))}
    if max_new_tokens is not None:
        payload["max_new_tokens"] = max_new_tokens
    if deadline is not None:
        payload["deadline"] = deadline
    if priority:
        payload["priority"] = priority
    if session_id is not None:
        payload["session_id"] = session_id
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/v1/chat", json.dumps(payload),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            raw = resp.read()
            try:
                body = json.loads(raw.decode() or "null")
            except json.JSONDecodeError:
                body = raw.decode(errors="replace")
            return {"status": resp.status, "body": body, "tokens": [],
                    "error": body.get("error")
                    if isinstance(body, dict) else str(body)}
        tokens: List[int] = []
        stamps: List[float] = []
        done: Optional[Dict[str, Any]] = None
        error: Optional[str] = None
        # SSE framing: "data: <json>\n" lines separated by blank lines
        while True:
            line = resp.readline()
            if not line:
                break                        # EOF closes the stream
            line = line.strip()
            if not line.startswith(b"data:"):
                continue
            event = json.loads(line[len(b"data:"):].decode())
            if "token" in event:
                tokens.append(event["token"])
                stamps.append(time.perf_counter())
            elif event.get("done"):
                done = event
                error = event.get("error")
                break
        ttft = stamps[0] - t0 if stamps else None
        itl = [b - a for a, b in zip(stamps, stamps[1:])]
        return {"status": 200, "tokens": tokens, "error": error,
                "ttft_s": ttft, "itl_s": itl, "done": done}
    finally:
        conn.close()
