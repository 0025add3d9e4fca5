"""The plain reference: what each cell computes, written again in plain
PyTorch and NumPy from the published definitions.

It imports nothing of ``torch_asg_tpu_torch`` and takes nothing that the
program made: it prepares the raw utterances and transcripts itself
(``prep.py``) and takes the weights as the benchmark drew them from the
seed (``weights.py``).  ``model.py`` holds the encoder, the ASG loss (the
fully-connected and the force-aligned lattice), AdamW and Viterbi scoring;
it runs in float64 unless told otherwise, and ``tf32`` rounds every
convolution and matrix product operand to TF32 (10 mantissa bits), which is
the control: the reference one precision step below the configuration's.
"""
