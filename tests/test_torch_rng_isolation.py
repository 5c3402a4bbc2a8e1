"""The port's tests leave the shared N256 client's rng where they found it.

tests/conftest.py caches one (ClientKey, ServerKeySet) per parameter set for
the whole session, and ClientKey.encrypt_bits draws from the client's one
`rng`. The JAX package's tests/test_aes_fhe.py::test_noise_probe_empirical
encrypts with the PARAMS_TEST_N256 client and checks a variance ratio, so
its inputs are whatever state earlier tests on the same worker left. A port
test file hands `keys_test_n256` only to helpers that draw nothing from its
client (port_keys, port_context) or that give it a private copy of the rng
(private_keys); these tests check both halves of that rule."""

import ast
import pathlib

import numpy as np

from tests.torch_port_common import port_context, port_keys, private_keys

TESTS = pathlib.Path(__file__).resolve().parent
# the helpers a port test may hand keys_test_n256 to
ALLOWED = {"private_keys", "port_keys", "port_context"}


def _state(client):
    return client.rng.bit_generator.state


def test_port_helpers_leave_the_shared_rng_alone(keys_test_n256):
    """port_keys and port_context draw nothing from the client; private_keys'
    client draws what the shared one would have drawn next, from its own
    copy of the rng."""
    jclient = keys_test_n256[0]
    before = _state(jclient)
    port_keys(keys_test_n256)
    port_context(keys_test_n256, truncate=True)
    bits = np.array([[1, 0], [0, 1]])
    mine, sks = private_keys(keys_test_n256)
    assert sks is keys_test_n256[1]
    first = mine.encrypt_bits(bits)
    assert _state(jclient) == before and _state(mine) != before
    np.testing.assert_array_equal(
        private_keys(keys_test_n256)[0].encrypt_bits(bits), first)
    assert (jclient.decrypt_bits(first) == bits).all()
    assert _state(jclient) == before


def _uses(path: pathlib.Path):
    """(line, call name or None) for each read of keys_test_n256 in path:
    the name of the call it is a direct argument of, else None."""
    tree = ast.parse(path.read_text())
    parents = {id(child): node for node in ast.walk(tree)
               for child in ast.iter_child_nodes(node)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and node.id == "keys_test_n256":
            call = parents.get(id(node))
            name = (call.func.id if isinstance(call, ast.Call)
                    and isinstance(call.func, ast.Name)
                    and node in call.args else None)
            yield node.lineno, name


def test_no_port_test_file_hands_out_the_shared_n256_client():
    """Every read of keys_test_n256 in a tests/test_torch_*.py file (but
    this one, whose reads draw nothing) is an argument of one of ALLOWED;
    the files that take the fixture are found, so the scan is not empty."""
    takers, bad = [], []
    for path in sorted(TESTS.glob("test_torch_*.py")):
        if path.name == pathlib.Path(__file__).name:
            continue
        uses = list(_uses(path))
        if uses:
            takers.append(path.name)
        bad += [f"{path.name}:{line} ({name})" for line, name in uses
                if name not in ALLOWED]
    assert not bad, ("keys_test_n256 handed to something that may draw from "
                     f"its client's rng: {bad}")
    assert {"test_torch_ctr_fhe.py", "test_torch_sbox_pbs.py",
            "test_torch_noise.py"} <= set(takers)


def test_the_scan_flags_a_direct_draw(tmp_path):
    """The scan itself: an unpacked fixture, a direct call and an argument
    of an allowed helper, told apart."""
    src = tmp_path / "test_torch_probe.py"
    src.write_text(
        "def test_a(keys_test_n256):\n"
        "    jclient, _ = keys_test_n256\n"
        "    encrypt(keys_test_n256)\n"
        "    port_keys(keys_test_n256)\n")
    assert list(_uses(src)) == [(2, None), (3, "encrypt"),
                                (4, "port_keys")]
