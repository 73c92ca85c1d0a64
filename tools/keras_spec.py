#!/usr/bin/env python3
"""Write the topology of a keras.applications model as the port's Keras
spec JSON (``graph/keras_convert.py::KerasSpec.to_json``: layer calls,
the config keys ``build_module`` reads, variable paths, shapes and trainable
flags; no weights).

    KERAS_BACKEND=jax python tools/keras_spec.py [--check]

Writes ``sparkdl_tpu_torch/models/keras_specs/inception_v3.json`` from
``keras.applications.InceptionV3(weights=None)`` (299×299×3 in, a
1000-way softmax; ``weights=None`` downloads nothing). With ``--check``
it writes nothing and exits 1 if the committed file differs. A machine
without keras builds the model from this file and weights it draws
itself (``chip_smoke.py``'s ``keras_estimator`` phase).
"""

import os
import sys

os.environ.setdefault("KERAS_BACKEND", "jax")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("CUDA_VISIBLE_DEVICES", "-1")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SPEC_PATH = os.path.join(REPO, "sparkdl_tpu_torch", "models", "keras_specs",
                         "inception_v3.json")


def inception_v3_json() -> str:
    import keras

    from sparkdl_tpu_torch.graph.keras_convert import keras_spec
    model = keras.applications.InceptionV3(weights=None)
    return keras_spec(model).to_json()


def main(argv) -> int:
    text = inception_v3_json()
    if "--check" in argv:
        with open(SPEC_PATH) as f:
            same = f.read() == text
        print(f"{SPEC_PATH}: {'up to date' if same else 'differs'}")
        return 0 if same else 1
    with open(SPEC_PATH, "w") as f:
        f.write(text)
    print(f"wrote {SPEC_PATH} ({len(text)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
