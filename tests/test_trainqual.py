"""CI-speed training-quality gate (VERDICT r2 next-1).

The full gate (bench_trainqual.py) fits to early-stop at near-reference
scale on the GPU; this variant proves on the CPU mesh, inside CI budget,
that ``Trainer.fit`` *converges to a model that segments* — not merely that
loss decreases. The phantom here is the easy end of the family (perfectly
aligned priors, low noise) so a few epochs suffice; the assertion is a real
Dice floor, not ``> 0``.
"""

import os

import numpy as np

from subcort_tpu.config import Options
from subcort_tpu.engine.data import TrainingIndex, build_training_index, \
    list_training_subjects
from subcort_tpu.engine.train import Trainer
from subcort_tpu.registration.atlas import make_synthetic_cohort

from bench_trainqual import evaluate_holdout


def test_training_converges_to_segmenting_model(tmp_path):
    cohort = str(tmp_path / "cohort")
    make_synthetic_cohort(cohort, n_subjects=3, shape=(48, 54, 44), seed=1,
                          noise=4.0, prior_error=0)
    # 6 epochs reach holdout Dice 0.88 / valid_acc 0.92 on this phantom
    # (measured curve: 0.53, 0.74, 0.79, 0.83, 0.83, 0.88) — enough margin
    # over the 0.85/0.90 floors while staying inside CI budget
    options = Options(experiment="trainqual_ci", train_folder=cohort,
                      max_epochs=6, patience=8, batch_size=128,
                      train_split=0.25, net_verbose=0, load_weights=False,
                      debug=False, seed=1)
    subjects = list_training_subjects(options)
    index = build_training_index(options, subjects=subjects[:2])
    # cap the (already-shuffled) index for CI speed; the full-scale gate is
    # bench_trainqual.py / TRAINQUAL_r*.json
    cap = 4096
    index = TrainingIndex(index.volumes, index.centers[:cap],
                          index.labels[:cap], index.atlas[:cap],
                          index.subject_names)

    trainer = Trainer(options, weights_path=str(tmp_path / "nets"))
    history = trainer.fit(index)
    best = min(history, key=lambda h: h["valid_loss"])
    assert best["valid_accuracy"] >= 0.90, history

    import jax

    from subcort_tpu.models.importer import load_theano_checkpoint
    params = jax.device_put(load_theano_checkpoint(trainer.weights_file))
    holdout = os.path.dirname(subjects[2].t1_path)
    dice = evaluate_holdout(params, holdout, options)
    assert dice >= 0.85, f"held-out cohort dice {dice:.4f} < 0.85"
