"""The reference-vector suites on the port (webaudio_tpu_torch), on the CPU.

Each tests/test_reference_vectors*.py (the reference's own unit tests,
transcribed for the JAX package) runs on the port through
tests/torch_switch.py: the file is read as text, `webaudio_tpu` becomes
`webaudio_tpu_torch`, contexts default to `device="cpu"`, the mixing
suite's numpy inputs become tensors and the worklet suite's `jax.numpy`
processors get torch twins.  Every test a suite defines is collected here
as `test_<suite>__<name>`, with the same expected values and bounds; the
files are read, never edited.

Left out, each named in LEFT_OUT with its reason: the cases that read the
reference's sample files, which the repository does not hold.
"""

from torch_switch import HERE, collect

SUITES = sorted(HERE.glob("test_reference_vectors*.py"))

LEFT_OUT = {
    ("test_reference_vectors_online.py", "test_decode_audio_data_sync"):
        "decodes the reference's samples/sample.wav, which the repository "
        "does not hold (tests/test_torch_decoding.py decodes written files)",
}

globals().update(collect(SUITES, LEFT_OUT, "test_reference_vectors"))


def test_left_out_cases_exist():
    """Every case left out names a test that its suite still defines."""
    for file, name in LEFT_OUT:
        assert f"def {name}(" in (HERE / file).read_text(), (file, name)
