"""K1, the joint generation (``csrc/joint.cu``): per trial and day, six
counter normals, the regime's multivariate t with its chi-square
Chebyshev fit, three GARCH(1,1) variances, the DCC-lite Q, the 3x3
Cholesky, VIX and IRX, over all T = sim + buffer days.

Bytes: the regime path read once ([T, B] float32) and the five outputs
written once (x0, x1, x2, VIX, IRX: 5 x [T, B] float32), plus the trial
ids and signs (8 bytes a trial). Operations: 419 float32 operations a
trial-day, counted from the day body (a transcendental counts as one): 115
in the draws (the six uniforms' scale and offset, Box-Muller, the 13-step
Clenshaw pass at 4 each, an exp, the scale, the signs, IRX) and 304 in the
carry chain (GARCH, DCC, the correlation and Cholesky, x, z, VIX), a
NaN-propagating max or min as 3, a clip as 6; the integer counter hashing
is not counted, nor the regime blends of the parameters (with the regime 0
or 1 they are loads of per-regime rows). At 16,384 trials x 8,820 days
this is 3.468e9 bytes and 6.055e10 operations: 1.035 ms at 3.35 TB/s."""

KERNEL = "joint_kernel"
OPS_PER_TRIAL_DAY = 419


def count(shape: dict):
    B = shape["trials"]
    T = shape["sim_days"] + shape["buffer_days"]
    return OPS_PER_TRIAL_DAY * T * B, 6 * T * B * 4 + 8 * B
