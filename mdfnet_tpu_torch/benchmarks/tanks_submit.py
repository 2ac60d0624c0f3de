"""Tanks & Temples submission packaging (the port's copy of
``mdfnet_tpu/benchmarks/tanks_submit.py``; host code).

    python -m mdfnet_tpu_torch.benchmarks.tanks_submit --ply_dir PLYS
        --log_dir LOGS [-o OUT] [-s intermediate|advanced|both]
        [--upload CREDENTIALS]

Twin of reference tools/tanks.log/upload_t2_results.py: the benchmark server
expects, per scene, a `<Scene>.ply` fused cloud and the dataset-provided
`<Scene>.log` camera trajectory, plus an MD5 manifest. This module packages
the pair set + checksums into a submission directory; ``--upload`` posts
it to the benchmark's bucket (``requests``, imported only then; it needs a
network).
"""
from __future__ import annotations

import hashlib
import os
import shutil
from typing import Dict, Sequence

INTERMEDIATE = ("Family", "Francis", "Horse", "Lighthouse", "M60", "Panther",
                "Playground", "Train")
ADVANCED = ("Auditorium", "Ballroom", "Courtroom", "Museum", "Palace", "Temple")


def md5_of(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def package_submission(ply_dir: str, log_dir: str, out_dir: str,
                       scenes: Sequence[str] = INTERMEDIATE + ADVANCED,
                       log_fn=print) -> Dict[str, str]:
    """Collect <scene>.ply + <scene>.log pairs into out_dir with an MD5
    manifest (the format generate_md5_file produces in the reference)."""
    os.makedirs(out_dir, exist_ok=True)
    sums = {}
    for scene in scenes:
        ply = os.path.join(ply_dir, f"{scene}.ply")
        log = os.path.join(log_dir, f"{scene}.log")
        if not os.path.exists(ply):
            if log_fn:
                log_fn(f"skip {scene}: no {ply}")
            continue
        if not os.path.exists(log):
            raise FileNotFoundError(
                f"{scene}.log missing — the camera trajectory ships with the "
                f"T&T dataset and must sit in {log_dir}")
        shutil.copy2(ply, os.path.join(out_dir, f"{scene}.ply"))
        shutil.copy2(log, os.path.join(out_dir, f"{scene}.log"))
        sums[f"{scene}.ply"] = md5_of(ply)
        sums[f"{scene}.log"] = md5_of(log)

    manifest = os.path.join(out_dir, "md5.txt")
    with open(manifest, "w") as f:
        for name, digest in sorted(sums.items()):
            f.write(f"{digest}  {name}\n")
    if log_fn:
        log_fn(f"packaged {len(sums) // 2} scenes -> {out_dir}")
    return sums


def upload_submission(out_dir: str, credentials: str,
                      scenes: Sequence[str] = INTERMEDIATE + ADVANCED,
                      log_fn=print) -> None:
    """Upload packaged <scene>.ply/.log pairs to the T&T GCS bucket.

    Protocol twin of reference upload_t2_results.py:75-112 (submit_file):
    the benchmark portal hands out a credentials file whose lines are
    ``policy###signature###filename`` (one per expected file) with a final
    ``###prefix###client_email###expiration`` access line; each file is
    POSTed to the t2-website-userdata bucket with its pre-signed policy.
    Network egress is required — in an offline environment this raises on
    the first POST, and `package_submission`'s output can be uploaded from
    any connected machine instead.
    """
    import requests

    with open(credentials) as f:
        lines = [l.strip() for l in f if l.strip()]
    policy_by_file = {}
    signature_by_file = {}
    for line in lines[:-1]:
        policy, signature, fname = line.split("###")
        policy_by_file[fname] = policy
        signature_by_file[fname] = signature
    _, prefix, client_email, _expiration = lines[-1].split("###")

    bucket = "t2-website-userdata"
    url = f"http://{bucket}.storage.googleapis.com"
    session = requests.Session()
    for scene in scenes:
        for ext in (".ply", ".log"):
            fname = f"{scene}{ext}"
            path = os.path.join(out_dir, fname)
            if not os.path.exists(path) or fname not in policy_by_file:
                continue
            policy = {
                "key": prefix + fname,
                "bucket": bucket,
                "acl": "bucket-owner-read",
                "GoogleAccessId": client_email,
                "policy": policy_by_file[fname],
                "signature": signature_by_file[fname],
            }
            if log_fn:
                log_fn(f"uploading {fname}")
            with open(path, "rb") as fh:
                r = session.post(url, data=policy, files={"file": fh},
                                 headers={"enctype": "multipart/form-data"})
            if r.status_code != 204:
                raise RuntimeError(
                    f"upload of {fname} failed: HTTP {r.status_code}")
    if log_fn:
        log_fn("upload complete")


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(description="T&T submission")
    parser.add_argument("--ply_dir", required=True)
    parser.add_argument("--log_dir", required=True,
                        help="dataset-provided <scene>.log trajectories")
    parser.add_argument("-o", "--out_dir", default="t2_submission")
    parser.add_argument("-s", "--set", default="both",
                        choices=["intermediate", "advanced", "both"])
    parser.add_argument("--upload", default=None, metavar="CREDENTIALS",
                        help="credentials file from the T&T portal; uploads "
                             "the packaged pairs (needs network egress)")
    args = parser.parse_args(argv)
    scenes = {"intermediate": INTERMEDIATE, "advanced": ADVANCED,
              "both": INTERMEDIATE + ADVANCED}[args.set]
    package_submission(args.ply_dir, args.log_dir, args.out_dir, scenes)
    if args.upload:
        upload_submission(args.out_dir, args.upload, scenes)


if __name__ == "__main__":
    main()
