"""Dump the word vocabulary of a labeled LMDB to a pickle.

The port's copy of `tools/gen_voc.py`, on `dig_tpu_torch`'s LMDB reader:
the same arguments, the same pickle, no JAX.

Equivalent of the reference's tools/gen_voc.py:1-25 (which scans a synth
LMDB's ``label-%09d`` records and pickles the unique lowercase words).
"""

from __future__ import annotations

import argparse
import pickle

from dig_tpu_torch.data.lmdb_store import LmdbReader


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("lmdb_path")
    ap.add_argument("output_pkl")
    ap.add_argument("--lowercase", action=argparse.BooleanOptionalAction,
                    default=True, help="lowercase words (--no-lowercase to "
                    "keep case; the reference tool always lowercases)")
    args = ap.parse_args()

    reader = LmdbReader(args.lmdb_path)
    n = int(reader.get(b"num-samples"))
    voc = set()
    for i in range(1, n + 1):
        label = reader.get(b"label-%09d" % i)
        if label is None:
            continue
        word = label.decode("utf-8", errors="replace")
        voc.add(word.lower() if args.lowercase else word)
    with open(args.output_pkl, "wb") as f:
        pickle.dump(sorted(voc), f)
    print(f"wrote {len(voc)} words to {args.output_pkl}")


if __name__ == "__main__":
    main()
