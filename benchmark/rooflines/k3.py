"""K3, the composition with signals and strategies
(``csrc/compose_strategies.cu``): per trial and simulated day, the stress
and funding state, the leverage, costs and tracking error of the four
assets the strategies read, the 16 rolling signals and the 19 strategies'
day step.

Bytes: the six windowed channels read once (SPY, QQQ, TLT, VIX, IRX,
regime: 6 x [S, B] float32) and 65 float32 results a trial written once.
Operations: 2,000 float32 operations a trial-day, counted from the day
body (a transcendental counts as one); the integer counter hashing is not
counted. At 16,384 trials x 7,560 days this is 2.477e11 operations: 3.697
ms at 67 TFLOP/s."""

KERNEL = "compose_strategies_kernel"
OPS_PER_TRIAL_DAY = 2000


def count(shape: dict):
    B = shape["trials"]
    S = shape["sim_days"]
    return OPS_PER_TRIAL_DAY * S * B, 6 * S * B * 4 + 65 * B * 4
