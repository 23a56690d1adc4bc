"""Write the small TF discriminator checkpoint that tests/
test_torch_tf_import.py reads, and the JAX package's reading of it.

Needs TensorFlow (run once, on a host that has it):

    python scripts/make_tf_disc_fixture.py

It builds, with tf.compat.v1 variables and a `Saver`, a checkpoint in the
reference's layout (the scope Tacotron_model/inference/refnet_emt as the
shipped spk_disc checkpoints hold it: conv2d_i/conv2d, conv2d_i/
batch_normalization, rnn/gru_cell/{gates,candidate}, dense, and the GE2E
`w` and `b`, plus an int64 global_step) at filters (4, 4), depth 8 and 20
mels, with values drawn from a numpy seed, under tests/fixtures/
tf_disc_small/. Beside it, expected.npz holds the JAX package's
`read_tf_checkpoint` output ("vars/<name>") and its `tf_disc_to_flax`
trees ("params/<path>", "stats/<path>", "extras/<name>").
"""

import os
import shutil
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "2")

OUT = os.path.join(ROOT, "tests", "fixtures", "tf_disc_small")
SCOPE = "Tacotron_model/inference/refnet_emt"
FILTERS, DEPTH, MELS = (4, 4), 8, 20


def variables(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    v, c_in, f = {}, 1, MELS
    for i, ch in enumerate(FILTERS):
        p = f"{SCOPE}/conv2d_{i}"
        v[f"{p}/conv2d/kernel"] = rng.normal(0, 0.3, (3, 3, c_in, ch))
        v[f"{p}/conv2d/bias"] = rng.normal(0, 0.1, (ch,))
        bn = f"{p}/batch_normalization"
        v[f"{bn}/gamma"] = rng.uniform(0.5, 1.5, (ch,))
        v[f"{bn}/beta"] = rng.normal(0, 0.1, (ch,))
        v[f"{bn}/moving_mean"] = rng.normal(0, 0.2, (ch,))
        v[f"{bn}/moving_variance"] = rng.uniform(0.5, 2.0, (ch,))
        c_in, f = ch, -(-f // 2)
    feat = f * FILTERS[-1]
    g = f"{SCOPE}/rnn/gru_cell"
    v[f"{g}/gates/kernel"] = rng.normal(0, 0.3, (feat + DEPTH, 2 * DEPTH))
    v[f"{g}/gates/bias"] = rng.normal(1.0, 0.1, (2 * DEPTH,))
    v[f"{g}/candidate/kernel"] = rng.normal(0, 0.3, (feat + DEPTH, DEPTH))
    v[f"{g}/candidate/bias"] = rng.normal(0, 0.1, (DEPTH,))
    v[f"{SCOPE}/dense/kernel"] = rng.normal(0, 0.3, (DEPTH, 128))
    v[f"{SCOPE}/dense/bias"] = rng.normal(0, 0.1, (128,))
    v["w"] = np.asarray([10.0])
    v["b"] = np.asarray([-5.0])
    return {k: np.asarray(x, np.float32) for k, x in v.items()}


def main():
    import tensorflow as tf
    from tacotron2_tpu.disc.tf_import import read_tf_checkpoint, \
        tf_disc_to_flax

    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    tf1 = tf.compat.v1
    graph = tf.Graph()
    with graph.as_default():
        tvars = [tf1.Variable(x, name=name) for name, x in variables().items()]
        tvars.append(tf1.Variable(np.int64(1234), name="global_step"))
        saver = tf1.train.Saver(tvars)
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            saver.save(sess, os.path.join(OUT, "model.ckpt"),
                       global_step=1234, write_meta_graph=False)
    os.remove(os.path.join(OUT, "checkpoint"))

    got = read_tf_checkpoint(OUT)
    params, stats, extras = tf_disc_to_flax(got)
    flat = {f"vars/{k}": v for k, v in got.items()}

    def walk(tree, pre):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{pre}/{k}")
            else:
                flat[f"{pre}/{k}"] = np.asarray(v)

    walk(params, "params")
    walk(stats, "stats")
    walk(extras, "extras")
    np.savez(os.path.join(OUT, "expected.npz"), **flat)
    print(f"wrote {sorted(os.listdir(OUT))}: {len(got)} variables")


if __name__ == "__main__":
    main()
