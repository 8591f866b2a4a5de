"""Training-QUALITY parity: PR/AUC of a device-hist-trained detector vs a
sklearn-backend-trained one vs a detector trained by the REFERENCE'S OWN
code.

Detection parity is proven exact (tests/test_reference_golden.py); this
measures the other axis — whether the device histogram tree splitter
(waldboost_tpu/ops/fit.py; bin-edge thresholds, PARITY.md §3) trains
detectors as GOOD as the reference's sklearn CART
(/root/reference/waldboost/training.py:34-50).  All three trainers see the
SAME synthetic stream (fake_data_generator(seed=11)), the same config
(12x12x4 grad_hist shrink2/npo4/smooth1, alpha=0.2, depth-2, 1000/1000
pool quotas), and are evaluated by the SAME serving path + Evaluator
(waldboost_tpu/testing.py == reference testing.py:18-81 semantics) on a
held-out corpus (seed=999).

Run detached (trains 3 x N_STAGES stages):

  nohup python scripts/train_auc_parity.py > /tmp/auc_parity.log 2>&1 &

Prints one JSON line per trainer plus a final summary JSON.
"""

import json
import os
import sys
import time
from itertools import islice

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

if os.environ.get("PARITY_CPU", "0") == "1":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    jax.config.update("jax_platforms", "cpu")

N_STAGES = int(os.environ.get("PARITY_STAGES", "32"))
N_EVAL = int(os.environ.get("PARITY_EVAL", "200"))
MIN_TP = int(os.environ.get("PARITY_MIN_TP", "1000"))
MIN_FP = int(os.environ.get("PARITY_MIN_FP", "1000"))
TRAIN_SEED = 11
EVAL_SEED = 999
SHAPE = (12, 12, 4)


def _opts():
    import waldboost_tpu as wb
    return dict(shrink=2, n_per_oct=4, smooth=1,
                channels=wb.channels.grad_hist)


def _eval_auc(model, corpus):
    from waldboost_tpu.testing import evaluate_model
    ev = evaluate_model(corpus, model)
    res = ev.evaluate()
    return res["auc"], res["n_eval"]


def _train_ours(backend):
    import waldboost_tpu as wb
    from waldboost_tpu.utils import fake_data_generator

    gen = fake_data_generator(seed=TRAIN_SEED)
    model = wb.Model(SHAPE, _opts())
    pool = wb.SamplePool(min_tp=MIN_TP, min_fp=MIN_FP, seed=0)
    kw = dict(max_depth=2) if backend == "hist" \
        else dict(max_depth=2, backend="sklearn")
    wb.train(model, gen, pool=pool, learner=wb.Learner(alpha=0.2, **kw),
             length=N_STAGES)
    return model


def _train_reference(tmpdir="/tmp"):
    """Train with the reference's OWN wb.train under the test shims, then
    load the reference-written .pb into this framework for serving."""
    for name, val in [("bool", bool), ("int", int), ("float", float)]:
        if name not in np.__dict__:
            setattr(np, name, val)
    shims = os.path.join(REPO, "tests", "refshims")
    for p in (shims, "/root/reference"):
        if p not in sys.path:
            sys.path.insert(0, p)
    import waldboost_tpu.proto.model_pb2 as pb2
    sys.modules.setdefault("waldboost.model_pb2", pb2)
    import waldboost as ref

    from waldboost_tpu.utils import fake_data_generator

    def gen():
        # the reference's label_boxes crashes on EMPTY (0-box) ground truth
        # (np.max over a (N, 0) overlap, samples.py:134) but handles
        # gt_boxes=None via its all-FP branch — identical labeling for an
        # objectless scene.  ~50% of fake_data scenes have no object.
        for d in fake_data_generator(seed=TRAIN_SEED):
            gt = d["groundtruth_boxes"]
            yield dict(image=d["image"],
                       groundtruth_boxes=gt if len(gt) else None)

    gen = gen()
    rmodel = ref.Model(SHAPE, dict(shrink=2, n_per_oct=4, smooth=1,
                                   channels=ref.channels.grad_hist))
    rpool = ref.SamplePool(min_tp=MIN_TP, min_fp=MIN_FP)
    ref.train(rmodel, gen, learner=ref.training.Learner(alpha=0.2,
                                                        max_depth=2),
              pool=rpool, length=N_STAGES)
    path = os.path.join(tmpdir, "ref_trained_parity.pb")
    rmodel.save(path)
    import waldboost_tpu as wb
    return wb.load(path)


def main():
    from waldboost_tpu.utils import fake_data_generator

    corpus = list(islice(fake_data_generator(seed=EVAL_SEED), N_EVAL))
    out = {}
    for name, fn in [("hist", lambda: _train_ours("hist")),
                     ("sklearn", lambda: _train_ours("sklearn")),
                     ("reference", _train_reference)]:
        t0 = time.perf_counter()
        model = fn()
        t_train = time.perf_counter() - t0
        t0 = time.perf_counter()
        auc, n_eval = _eval_auc(model, corpus)
        rec = {"trainer": name, "auc": round(auc, 4), "n_eval": n_eval,
               "stages": N_STAGES, "train_s": round(t_train, 1),
               "eval_s": round(time.perf_counter() - t0, 1)}
        out[name] = auc
        print(json.dumps(rec), flush=True)
    print(json.dumps({"summary": {k: round(v, 4) for k, v in out.items()},
                      "hist_minus_reference": round(
                          out["hist"] - out["reference"], 4),
                      "hist_minus_sklearn": round(
                          out["hist"] - out["sklearn"], 4)}), flush=True)


if __name__ == "__main__":
    main()
