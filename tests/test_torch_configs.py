"""Torch port: every config class keeps the JAX package's field names and
defaults, and the module constants are recomputed identically (exact)."""
import numpy as np
import pytest

import orbslam3_tpu.frontend.orb as j_orb
import orbslam3_tpu.frontend.stereo as j_stereo
import orbslam3_tpu.imu.preintegration as j_pre
import orbslam3_tpu.map.slam_map as j_map
import orbslam3_tpu.models.slam as j_slam
import orbslam3_tpu.models.tracker as j_tracker
import orbslam3_tpu.ops.brief as j_brief
import orbslam3_tpu.ops.fast as j_fast
import orbslam3_tpu.ops.pyramid as j_pyr
import orbslam3_tpu_torch.frontend.orb as t_orb
import orbslam3_tpu_torch.frontend.stereo as t_stereo
import orbslam3_tpu_torch.imu.preintegration as t_pre
import orbslam3_tpu_torch.map.slam_map as t_map
import orbslam3_tpu_torch.models.slam as t_slam
import orbslam3_tpu_torch.models.tracker as t_tracker
import orbslam3_tpu_torch.ops.brief as t_brief
import orbslam3_tpu_torch.ops.fast as t_fast
import orbslam3_tpu_torch.ops.pyramid as t_pyr

CONFIGS = [
    (j_slam.SlamConfig, t_slam.SlamConfig),
    (j_orb.OrbConfig, t_orb.OrbConfig),
    (j_stereo.StereoConfig, t_stereo.StereoConfig),
    (j_tracker.TrackConfig, t_tracker.TrackConfig),
    (j_map.MapCapacity, t_map.MapCapacity),
    (j_pre.ImuNoise, t_pre.ImuNoise),
]


@pytest.mark.parametrize("jcls,tcls", CONFIGS, ids=[c[0].__name__ for c in CONFIGS])
def test_config_fields_and_defaults(jcls, tcls):
    assert tcls._fields == jcls._fields
    jd, td = jcls._field_defaults, tcls._field_defaults
    assert set(jd) == set(td)
    for k in jd:
        # nested configs compare element-wise as tuples
        assert tuple(td[k]) == tuple(jd[k]) if isinstance(jd[k], tuple) else td[k] == jd[k], k


def test_state_field_names():
    from orbslam3_tpu.models import fused as j_fused
    from orbslam3_tpu_torch.frontend.orb import Features
    from orbslam3_tpu_torch.models import fused as t_fused

    assert t_map.MapState._fields == j_map.MapState._fields
    assert t_pre.PreintState._fields == j_pre.PreintState._fields
    assert Features._fields == j_orb.Features._fields
    assert t_fused.TrackState._fields == j_fused.TrackState._fields
    assert t_fused.FrameOut._fields == j_fused.FrameOut._fields
    assert (t_fused.MODE_NOT_INIT, t_fused.MODE_OK, t_fused.MODE_RECENTLY_LOST) == (
        j_fused.MODE_NOT_INIT, j_fused.MODE_OK, j_fused.MODE_RECENTLY_LOST)


def test_constants_equal():
    np.testing.assert_array_equal(t_brief.BRIEF_PATTERN, np.asarray(j_brief.BRIEF_PATTERN))
    np.testing.assert_array_equal(t_brief.ORI_MASK, np.asarray(j_brief.ORI_MASK))
    np.testing.assert_array_equal(t_brief.ORI_X, np.asarray(j_brief.ORI_X))
    np.testing.assert_array_equal(t_brief.ORI_Y, np.asarray(j_brief.ORI_Y))
    np.testing.assert_array_equal(t_fast.CIRCLE, j_fast.CIRCLE)
    assert (t_brief.PATCH, t_brief.GATHER, t_brief.ORI_RADIUS) == (
        j_brief.PATCH, j_brief.GATHER, j_brief.ORI_RADIUS)
    assert t_orb.BORDER == j_orb.BORDER
    np.testing.assert_array_equal(t_pyr.gaussian_kernel_1d(2.0, 3),
                                  np.asarray(j_pyr.gaussian_kernel_1d(2.0, 3)))


@pytest.mark.parametrize("n_features,n_levels", [(1024, 8), (384, 4), (1200, 8), (500, 6)])
def test_level_quotas_and_shapes(n_features, n_levels):
    jc = j_orb.OrbConfig(n_features=n_features, n_levels=n_levels)
    tc = t_orb.OrbConfig(n_features=n_features, n_levels=n_levels)
    assert t_orb.level_quotas(tc) == j_orb.level_quotas(jc)
    assert t_pyr.level_shapes(480, 752, n_levels, 1.2) == j_pyr.level_shapes(480, 752, n_levels, 1.2)
