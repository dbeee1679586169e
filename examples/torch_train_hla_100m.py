"""End-to-end example (PyTorch port): train a ~100M-parameter HLA2 LM for a
few hundred steps with the full training stack (fault-tolerant loop,
checkpoints, metrics jsonl) on one device.

    PYTHONPATH=src python examples/torch_train_hla_100m.py --steps 200 [--device cpu]

Twin of ``examples/train_hla_100m.py`` on ``src/repro_torch``: the same
flags handed to ``repro_torch.launch.train.main`` (``STEPS`` from the
environment, default 200), less the mesh (``HOST_DEVICES``), with the
checkpoint directory and the metrics file in the temporary directory.
Arguments after the script's own override them (``--device cpu`` runs it on
the CPU).  On the card the mixer runs the HLA2 chunk kernels, forward and
backward.
"""

import os
import sys
import tempfile

_TMP = tempfile.gettempdir()
sys.argv = [sys.argv[0]] + [
    "--arch", "hla-1b", "--reduced", "--steps",
    os.environ.get("STEPS", "200"),
    "--batch", "8", "--seq", "512",
    "--ckpt-dir", os.path.join(_TMP, "hla100m_ckpt"),
    "--ckpt-every", "100",
    "--metrics", os.path.join(_TMP, "hla100m_metrics.jsonl"),
] + sys.argv[1:]

# ~100M config: widen the reduced config before launch.train parses args
import repro_torch.configs.hla_1b as hla_1b  # noqa: E402


def _reduced_100m():
    return hla_1b.CONFIG.replace(
        n_layers=8, d_model=768, n_heads=12, n_kv_heads=12, d_ff=2048,
        vocab=32768, remat="none", dtype="float32",
    )


hla_1b.reduced = _reduced_100m

from repro_torch.launch.train import main  # noqa: E402

if __name__ == "__main__":
    main()
