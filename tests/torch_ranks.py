"""Start CPU ranks of the PyTorch port for a test and collect their results.

``run_ranks`` writes the inputs (an npz) and a JSON spec into a directory,
starts ``world`` processes of ``tests/torch_rank_worker.py`` (never a
function of a test module: a child could not import it), each with the JAX
package's launch contract and a ``file://`` rendezvous in that directory,
waits for all of them under a hard timeout that kills the rest, and
returns each rank's ``out_<rank>.npz`` as a dict.  The children import
torch and the port only; they do not pass through ``tests/conftest.py``.
They see no card unless ``cuda`` is set (the card tests' ranks share it
over gloo).
"""

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

WORKER = pathlib.Path(__file__).resolve().parent / "torch_rank_worker.py"


def run_ranks(workdir, world, spec, inputs, timeout=150, cuda=False):
    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    np.savez(workdir / "inputs.npz", **inputs)
    spec = dict(spec, inputs=str(workdir / "inputs.npz"))
    spec_path = workdir / "spec.json"
    spec_path.write_text(json.dumps(spec))
    rdv = workdir / "rendezvous"
    if rdv.exists():
        rdv.unlink()
    env = dict(os.environ, DSTPU_COORDINATOR=f"file://{rdv}",
               DSTPU_NUM_PROCESSES=str(world), OMP_NUM_THREADS="1",
               PYTHONWARNINGS="ignore")
    if not cuda:
        env["CUDA_VISIBLE_DEVICES"] = ""
    procs = []
    try:
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), str(spec_path), str(rank)],
                env=dict(env, DSTPU_PROCESS_ID=str(rank)),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + timeout
        logs = []
        for p in procs:
            left = max(1.0, deadline - time.monotonic())
            logs.append(p.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{world} ranks did not finish within "
                             f"{timeout} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, log[-3000:])
           for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    if bad:
        raise AssertionError(f"ranks failed: {bad}")
    return [dict(np.load(workdir / f"out_{r}.npz")) for r in range(world)]
