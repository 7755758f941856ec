"""The statement generators against the port's examples at toy size, and
the port proving what they make."""

import pytest

from benchmark import program, statements
from benchmark.reference.air import schema_of
from benchmark.tests.conftest import toy_cell
from examples.mimc_torch import round_constants, run_mimc
from examples.poseidon_torch import F_ROUNDS, P_ROUNDS, SBOX, poseidon_params
from examples.poseidon_utils import MerkleTree, create_hash
from genstark_tpu_torch.field import P128, create_prime_field


def test_mimc_statement_is_the_examples_recurrence():
    c = toy_cell("mimc128-2p20")
    field = create_prime_field(P128)
    constants = round_constants(field)
    assert [k % P128 for k in c.config["schema"]["static_registers"][0]["values"]] == constants
    st = statements.module("mimc").make(c.config, c.traffic, 2 ** 40 + 3, 5)
    controls = run_mimc(field, 64, constants, st.inputs[0][0])
    assert st.assertions == [(0, 0, controls[0]), (63, 0, controls[-1])]


def test_poseidon_statement_folds_the_examples_root():
    c = toy_cell("poseidon-merkle-d16")
    field = create_prime_field(P128)
    oracle = create_hash(field.host, SBOX, F_ROUNDS, P_ROUNDS, 6)
    for index in range(4):
        st = statements.module("poseidon_branch").make(c.config, dict(c.traffic, depth=4),
                                                      2 ** 40 + 3, index)
        leaf = [st.inputs[0][0], st.inputs[1][0]]
        siblings = list(zip(st.inputs[2][0], st.inputs[3][0]))
        bits = st.public[0][0]
        position = sum(b << (i - 1) for i, b in enumerate(bits) if i)
        root = [st.assertions[0][2], st.assertions[1][2]]
        assert MerkleTree.verify(root, position, [leaf] + [list(s) for s in siblings], oracle)


def test_statements_depend_on_seed_and_index():
    c = toy_cell("mimc128-2p20")
    make = statements.module("mimc").make
    values = {make(c.config, c.traffic, s, i).inputs[0][0] for s in (1, 2 ** 33) for i in (0, 1)}
    assert len(values) == 4
    assert make(c.config, c.traffic, 7, 1) == make(c.config, c.traffic, 7, 1)


@pytest.mark.parametrize("workload", ["mimc128-2p20", "poseidon-merkle-d16"])
def test_port_proves_the_statements(workload):
    c = toy_cell(workload)
    stark = program.build_stark(c.config, c.traffic, "cpu")
    st = statements.module(c.config["statements"]).make(c.config, c.traffic, 11, 0)
    a = program.assertions(st)
    assert program.verify(stark, st, a, program.prove(stark, st, a))


def test_poseidon_constants_are_the_examples():
    c = toy_cell("poseidon-merkle-d16")
    _, mds, rc = poseidon_params(6)
    assert c.config["poseidon"]["mds"] == mds
    assert [list(row) for row in zip(*rc)] == c.config["poseidon"]["round_constants"]


def test_script_config_compiles_to_the_reference_air():
    """The Poseidon configuration's AirScript source, compiled by the port,
    has the constraints and static registers that the reference builds
    from the configuration's parameters by plain code."""
    c = toy_cell("poseidon-merkle-d16")
    compiled = program.build_stark(c.config, c.traffic, "cpu").air.schema
    built = schema_of(c.config)
    plain = program._schema(dict(c.config, schema=dict(built, init=[0] * 12,
                                                        transition=[0] * 12)), c.traffic)
    assert compiled.static_registers == plain.static_registers
    assert compiled.constraints == plain.constraints
    assert compiled.base_steps == plain.base_steps
