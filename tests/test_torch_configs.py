"""The port's config registry equals the reference's, arch for arch."""
import dataclasses

import pytest

from repro import configs as jcfg
from repro_torch import configs as tcfg
from repro_torch.configs import base as tbase

ARCHS = jcfg.list_archs()


def test_registry_lists_the_same_archs():
    assert tcfg.list_archs() == ARCHS
    # the synthetic compiler graphs ride the same registry
    assert tcfg.list_synths() == jcfg.list_synths()


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_layer_groups_match(arch, smoke):
    ref = jcfg.get_config(arch, smoke=smoke)
    got = tcfg.get_config(arch, smoke=smoke)
    # the port's own fields (``configs.base.PORT_ONLY``) sit at their
    # defaults in every preset, and the rest is the reference's config
    assert tbase.reference_dict(got) == dataclasses.asdict(ref)
    for sub in (got.moe, got.mla):
        for name in tbase.PORT_ONLY.get(type(sub).__name__, ()):
            default = type(sub).__dataclass_fields__[name].default
            assert getattr(sub, name) == default, (arch, name)
    assert got.layer_groups() == ref.layer_groups()
    assert got.layer_kinds() == ref.layer_kinds()
    assert got.resolved_head_dim == ref.resolved_head_dim


def test_shapes_match():
    assert {k: dataclasses.asdict(v) for k, v in tcfg.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jcfg.SHAPES.items()}
    for arch in ARCHS:
        for name in jcfg.SHAPES:
            assert tcfg.shape_applicable(tcfg.get_config(arch),
                                         tcfg.SHAPES[name]) == \
                jcfg.shape_applicable(jcfg.get_config(arch),
                                      jcfg.SHAPES[name])


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        tcfg.get_config("no-such-model")
