#!/usr/bin/env python3
"""Carry the validation study's corpora from the machine that rendered them
to the one that trains on them, verified.

    python3 tools/study_corpora.py pack WORKDIR ARCHIVE [--format xz|gz]
    python3 tools/study_corpora.py unpack ARCHIVE WORKDIR

`gen_synth` draws its words with OpenCV's Hershey faces, and OpenCV builds
draw other glyphs (4.13 and 5.0 do), so a study that compares with another
run renders its corpora where that run's OpenCV is and carries them over.

`pack` writes WORKDIR/corpusA, WORKDIR/corpusB and their stage records
(WORKDIR/stages/corpus{A,B}.json: the argv and the OpenCV build the runner
wrote) into one tar archive, compressed with xz (Python's `lzma`) or gzip,
behind a manifest.json: each file's size and sha256, the OpenCV build and
the knobs the records' argv give.  It refuses a WORKDIR whose corpus
records are missing or name two builds.

`unpack` checks every file against the manifest and raises on any
difference, refuses to overwrite a corpus whose record in WORKDIR stands
with another build or another argv, then puts the corpora and their records
in place and leaves the manifest as WORKDIR/stages/corpora_manifest.json,
whose sha256 the runner's results.json names beside the corpora's build
(`validation_study.corpora_manifest`).  Prints the build and that sha256.
The runner then skips both corpus stages, their records matching its argv,
and goes on from `pretrain`.  An xz archive needs `lzma`: without it
`unpack` fails, it never reads the archive another way.
"""

import argparse
import hashlib
import io
import json
import os
import shutil
import sys
import tarfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dig_tpu_torch.tools import validation_study as vs  # noqa: E402

CORPORA = ("corpusA", "corpusB")
MANIFEST = "manifest.json"
FORMATS = ("xz", "gz")  # tarfile's mode suffixes
# the knobs each corpus's gen_synth argv carries
KNOB_FLAGS = {"corpusA": {"unlabeled": "--train"},
              "corpusB": {"labeled": "--labeled", "test": "--test", "words": "--train_words"}}


def sha256_file(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def corpus_files(workdir):
    """The files pack carries, relative to WORKDIR, in a fixed order."""
    rels = []
    for c in CORPORA:
        for dirpath, dirnames, filenames in os.walk(os.path.join(workdir, c)):
            dirnames.sort()
            rels += [os.path.relpath(os.path.join(dirpath, n), workdir) for n in sorted(filenames)]
    return rels + [os.path.join("stages", f"{c}.json") for c in CORPORA]


def read_records(workdir):
    records = {}
    for c in CORPORA:
        path = vs.marker_path(workdir, c)
        if not os.path.exists(path):
            raise ValueError(f"{workdir}: no record of {c} ({path}); render the corpora with "
                             f"`validation_study WORKDIR --stages corpusA,corpusB`")
        with open(path) as f:
            records[c] = json.load(f)
    return records


def pack(workdir, archive, fmt="xz"):
    """Writes ARCHIVE; returns the manifest's sha256."""
    workdir = os.path.abspath(workdir)
    records = read_records(workdir)
    builds = {r.get("opencv") for r in records.values()}
    if len(builds) != 1 or None in builds:
        raise ValueError(f"{workdir}: the corpus records name the OpenCV builds "
                         f"{ {c: r.get('opencv') for c, r in records.items()} }; pack one render")
    missing = [p for c in CORPORA for p in vs.products(vs.Stage(c, [], os.path.join(workdir, c)),
                                                       workdir) if not os.path.exists(p)]
    if missing:
        raise ValueError(f"{workdir}: the records stand but {missing} are gone")
    knobs = {k: int(r["argv"][r["argv"].index(flag) + 1])
             for c, r in records.items() for k, flag in KNOB_FLAGS[c].items()}
    rels = corpus_files(workdir)
    files = {rel: {"size": os.path.getsize(os.path.join(workdir, rel)),
                   "sha256": sha256_file(os.path.join(workdir, rel))} for rel in rels}
    raw = json.dumps({"opencv": builds.pop(), "knobs": knobs, "files": files},
                     indent=1).encode()
    with tarfile.open(archive, f"w:{fmt}") as tar:
        info = tarfile.TarInfo(MANIFEST)
        info.size = len(raw)
        tar.addfile(info, io.BytesIO(raw))
        for rel in rels:
            tar.add(os.path.join(workdir, rel), arcname=rel)
    digest = hashlib.sha256(raw).hexdigest()
    print(f"packed {len(rels)} files, {sum(f['size'] for f in files.values())} B, into "
          f"{archive} ({os.path.getsize(archive)} B, {fmt}); manifest sha256 {digest}")
    return digest


def open_archive(archive):
    try:
        return tarfile.open(archive, "r:*")
    except tarfile.ReadError as e:
        try:
            import lzma  # noqa: F401
        except ImportError:
            raise RuntimeError(f"{archive}: not read; an xz archive needs lzma and this Python "
                               f"has no lzma module; pack it again with --format gz") from e
        raise


def verify(tmp, manifest):
    """Raises unless the files under `tmp` are the manifest's, byte for byte."""
    found = set()
    for dirpath, _, filenames in os.walk(tmp):
        found |= {os.path.relpath(os.path.join(dirpath, n), tmp) for n in filenames}
    found.discard(MANIFEST)
    listed = manifest["files"]
    bad = sorted(found ^ set(listed))
    bad += [rel for rel in sorted(found & set(listed))
            if os.path.getsize(os.path.join(tmp, rel)) != listed[rel]["size"]
            or sha256_file(os.path.join(tmp, rel)) != listed[rel]["sha256"]]
    if bad:
        raise ValueError(f"the archive's files differ from its manifest: {bad}")


def unpack(archive, workdir):
    """Puts the archive's corpora and records into WORKDIR; returns the
    manifest's sha256."""
    workdir = os.path.abspath(workdir)
    tmp = os.path.join(workdir, ".unpack")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        with open_archive(archive) as tar:
            tar.extractall(tmp, filter="data")
        with open(os.path.join(tmp, MANIFEST), "rb") as f:
            raw = f.read()
        manifest = json.loads(raw)
        verify(tmp, manifest)
        records = read_records(tmp)
        for c, new in records.items():
            if new.get("opencv") != manifest["opencv"]:
                raise ValueError(f"{archive}: {c}'s record names OpenCV {new.get('opencv')}, "
                                 f"the manifest {manifest['opencv']}")
            path = vs.marker_path(workdir, c)
            if os.path.exists(path):
                with open(path) as f:
                    old = json.load(f)
                if (old.get("argv"), old.get("opencv")) != (new["argv"], new["opencv"]):
                    raise ValueError(f"{workdir}: {c} stands with OpenCV {old.get('opencv')} "
                                     f"and argv {old.get('argv')}; the archive's is OpenCV "
                                     f"{new['opencv']}, argv {new['argv']}: not overwritten")
        os.makedirs(os.path.join(workdir, "stages"), exist_ok=True)
        for c in CORPORA:
            shutil.rmtree(os.path.join(workdir, c), ignore_errors=True)
            os.replace(os.path.join(tmp, c), os.path.join(workdir, c))
            os.replace(vs.marker_path(tmp, c), vs.marker_path(workdir, c))
        with open(os.path.join(workdir, "stages", vs.CORPORA_MANIFEST), "wb") as f:
            f.write(raw)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    digest = hashlib.sha256(raw).hexdigest()
    print(f"unpacked {len(manifest['files'])} files into {workdir}: corpora rendered with "
          f"OpenCV {manifest['opencv']}, knobs {manifest['knobs']}; manifest sha256 {digest}")
    return digest


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("pack")
    p.add_argument("workdir")
    p.add_argument("archive")
    p.add_argument("--format", default="xz", choices=FORMATS)
    u = sub.add_parser("unpack")
    u.add_argument("archive")
    u.add_argument("workdir")
    args = ap.parse_args(argv)
    if args.cmd == "pack":
        pack(args.workdir, args.archive, args.format)
    else:
        unpack(args.archive, args.workdir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
