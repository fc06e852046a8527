"""Post-processing / evaluation pipeline: copies of ``rkmh_tpu/scripts``
(clean-room equivalents of the reference's scripts/ directory, SURVEY.md
§2.2), kept because importing any ``rkmh_tpu`` module imports JAX.  Their
imports point at the port (``crunch_score`` at this package's
``score_test_data``, ``make_mix`` at ``rkmh_tpu_torch.io.fastx``); their
output is byte-identical to the JAX package's.  Console scripts:
``rkmh-tpu-torch-<name>`` (``pyproject.toml``).

Each module exposes ``main(argv, stdin, stdout)`` so the same code is a
console script and a unit-testable function.  Semantics (thresholds,
output layout) match the cited reference script; the code is new.

| module                      | reference script                  | role |
|-----------------------------|-----------------------------------|------|
| score_real_classification   | score_real_classification.py      | hpv16 read output -> sample-level lineage/sublineage prevalence |
| score_test_data             | score_test_data.py                | score simulated coinfection mixes vs filename-encoded truth |
| crunch_score                | crunch_score.py                   | per-strain abs error vs truth for quant output |
| score_cls                   | score_cls.py                      | accuracy + composition from process_cls output |
| process_cls                 | process_cls.py / *_real_data.py   | extract truth + top lineage/sublineage per read |
| conf_mat                    | conf_mat.py                       | confusion counts for VW binary predictions |
| vwize                       | vwize.py                          | classification counts -> Vowpal Wabbit vectors |
| json_to_wabbit              | json_to_wabbit.py                 | JSON sketches -> VW vectors |
| collapse_subtypes           | collapse_subtypes.py              | collapse sublineage counts to lineages in VW vectors |
| interpret_wabbit            | interpret_wabbit.py               | human-readable VW logit interpretation |
| make_mix                    | make_mix.py / make_random_mix.py  | simulate coinfection read mixes (built-in sampler, no seqtk) |
| quant                       | rkmh_quant.sh                     | quick per-reference read counts from classify output |
"""
