#!/usr/bin/env python
"""Summarize a jax.profiler xplane.pb trace without tensorboard.

Decodes the protobuf wire format directly (schema:
tsl/profiler/protobuf/xplane.proto), so no profiler plugin is needed, and
aggregates device-op durations per plane/line to attribute the production
frame's device time.

Usage: python tools/xplane_summary.py chiprun_out/trace [--top 25]
"""

import argparse
import glob
import os
import sys
from collections import defaultdict


def _varint(buf, i):
    x = 0
    s = 0
    while True:
        b = buf[i]
        i += 1
        x |= (b & 0x7F) << s
        if not b & 0x80:
            return x, i
        s += 7


def _fields(buf):
    """Yield (field_number, wire_type, value) over one message's bytes."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _varint(buf, i)
        fno, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _varint(buf, i)
        elif wt == 1:
            v, i = buf[i:i + 8], i + 8
        elif wt == 2:
            ln, i = _varint(buf, i)
            v, i = buf[i:i + ln], i + ln
        elif wt == 5:
            v, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"wire type {wt}")
        yield fno, wt, v


def parse_plane(buf):
    name = ""
    lines = []
    emeta = {}
    for fno, wt, v in _fields(buf):
        if fno == 2 and wt == 2:
            name = v.decode("utf-8", "replace")
        elif fno == 3 and wt == 2:
            lines.append(v)
        elif fno == 4 and wt == 2:  # map<int64, XEventMetadata>
            k = None
            mname = ""
            for f2, w2, v2 in _fields(v):
                if f2 == 1 and w2 == 0:
                    k = v2
                elif f2 == 2 and w2 == 2:
                    for f3, w3, v3 in _fields(v2):
                        if f3 == 1 and w3 == 0 and k is None:
                            k = v3
                        elif f3 == 2 and w3 == 2:
                            mname = v3.decode("utf-8", "replace")
            if k is not None:
                emeta[k] = mname
    return name, lines, emeta


def parse_line(buf):
    lname = ""
    events = []
    for fno, wt, v in _fields(buf):
        if fno == 2 and wt == 2:
            lname = v.decode("utf-8", "replace")
        elif fno == 11 and wt == 2 and not lname:
            lname = v.decode("utf-8", "replace")
        elif fno == 4 and wt == 2:
            mid = dur = occ = 0
            for f2, w2, v2 in _fields(v):
                if f2 == 1 and w2 == 0:
                    mid = v2
                elif f2 == 3 and w2 == 0:
                    dur = v2
                elif f2 == 5 and w2 == 0:
                    occ = v2
            events.append((mid, dur, max(occ, 1)))
    return lname, events


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--plane-filter", default="/device:GPU",
                    help="substring of plane names to include")
    args = ap.parse_args()

    pbs = sorted(glob.glob(
        os.path.join(args.trace_dir, "**", "*.xplane.pb"), recursive=True))
    if not pbs:
        sys.exit(f"no xplane.pb under {args.trace_dir}")
    space = open(pbs[-1], "rb").read()
    print(f"# {pbs[-1]} ({len(space)/1e6:.1f} MB)")

    for fno, wt, v in _fields(space):
        if fno != 1 or wt != 2:
            continue
        pname, lines, emeta = parse_plane(v)
        if args.plane_filter and args.plane_filter not in pname:
            continue
        print(f"\n== plane: {pname} ({len(lines)} lines)")
        for lbuf in lines:
            lname, events = parse_line(lbuf)
            if not events:
                continue
            agg = defaultdict(lambda: [0, 0])  # name -> [ps, count]
            for mid, dur, occ in events:
                a = agg[emeta.get(mid, f"#{mid}")]
                a[0] += dur
                a[1] += occ
            total_ps = sum(a[0] for a in agg.values())
            print(f"\n-- line: {lname}  events={len(events)} "
                  f"total={total_ps/1e9:.3f} ms")
            rows = sorted(agg.items(), key=lambda kv: -kv[1][0])
            for name, (ps, cnt) in rows[:args.top]:
                print(f"  {ps/1e9:9.3f} ms  {100*ps/max(total_ps,1):5.1f}%  "
                      f"x{cnt:<5d} {name[:110]}")


if __name__ == "__main__":
    main()
