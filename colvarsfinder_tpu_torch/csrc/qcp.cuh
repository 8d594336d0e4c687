// QCP optimal-rotation solve shared by the Kabsch kernels: K1 and K2
// (kabsch.cu), and K6 (kabsch_exact.cu), which is built without FMA
// contraction.
//
// Device counterpart of quaternion_from_covariance in
// colvarsfinder_tpu_torch/ops/alignment.py (itself a port of
// colvarsfinder_tpu/ops/alignment.py:102-238): the optimal quaternion is the
// dominant eigenvector of Horn's traceless 4x4 key matrix K(C). Its largest
// eigenvalue comes from 16 Newton steps on the quartic characteristic
// polynomial started at the upper bound 2||C||_F; the eigenvector is the
// largest-norm row of the adjugate of K - lambda I ("strictly greater norm
// wins", first row on ties). The constants (16 steps, the |dp| > 1e-12
// guard, rsqrt(n + 1e-30)) are those of the JAX package.
#pragma once

namespace cvf {

__device__ __forceinline__ float det3(float a, float b, float c, float d,
                                      float e, float f, float g, float h,
                                      float i) {
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g);
}

constexpr int kNewtonIters = 16;

// c: the 9 entries (row-major) of a covariance pre-normalized by ||C||_F.
// R: the 9 rotation entries (row-major) in the row-vector convention
// y = x @ R. iters: Newton steps (kabsch_exact.cu takes 16 + the plain
// chain's extra differentiable steps; K1 and K2 always 16).
__device__ __forceinline__ void qcp_rotation(const float c[9], float R[9],
                                             int iters = kNewtonIters) {
    const float sxx = c[0], sxy = c[1], sxz = c[2];
    const float syx = c[3], syy = c[4], syz = c[5];
    const float szx = c[6], szy = c[7], szz = c[8];

    const float k00 = sxx + syy + szz;
    const float k01 = syz - szy;
    const float k02 = szx - sxz;
    const float k03 = sxy - syx;
    const float k11 = sxx - syy - szz;
    const float k12 = sxy + syx;
    const float k13 = szx + sxz;
    const float k22 = syy - sxx - szz;
    const float k23 = syz + szy;
    const float k33 = szz - sxx - syy;

    const float fro2 = sxx * sxx + sxy * sxy + sxz * sxz + syx * syx +
                       syy * syy + syz * syz + szx * szx + szy * szy +
                       szz * szz;
    const float c2 = -2.0f * fro2;
    const float c1 = -8.0f * det3(sxx, sxy, sxz, syx, syy, syz, szx, szy, szz);
    const float c0 =
        k00 * det3(k11, k12, k13, k12, k22, k23, k13, k23, k33) -
        k01 * det3(k01, k12, k13, k02, k22, k23, k03, k23, k33) +
        k02 * det3(k01, k11, k13, k02, k12, k23, k03, k13, k33) -
        k03 * det3(k01, k11, k12, k02, k12, k22, k03, k13, k23);

    float lam = 2.0f * sqrtf(fro2);
#pragma unroll
    for (int it = 0; it < iters; ++it) {
        const float p = ((lam * lam + c2) * lam + c1) * lam + c0;
        const float dp = (4.0f * lam * lam + 2.0f * c2) * lam + c1;
        lam = lam - p / (fabsf(dp) > 1e-12f ? dp : 1e-12f);
    }

    const float m00 = k00 - lam, m11 = k11 - lam;
    const float m22 = k22 - lam, m33 = k33 - lam;

    // cofactor rows of M = K - lam I; the global sign is irrelevant (q ~ -q)
    float rows[4][4] = {
        {det3(m11, k12, k13, k12, m22, k23, k13, k23, m33),
         -det3(k01, k12, k13, k02, m22, k23, k03, k23, m33),
         det3(k01, m11, k13, k02, k12, k23, k03, k13, m33),
         -det3(k01, m11, k12, k02, k12, m22, k03, k13, k23)},
        {-det3(k01, k02, k03, k12, m22, k23, k13, k23, m33),
         det3(m00, k02, k03, k02, m22, k23, k03, k23, m33),
         -det3(m00, k01, k03, k02, k12, k23, k03, k13, m33),
         det3(m00, k01, k02, k02, k12, m22, k03, k13, k23)},
        {det3(k01, k02, k03, m11, k12, k13, k13, k23, m33),
         -det3(m00, k02, k03, k01, k12, k13, k03, k23, m33),
         det3(m00, k01, k03, k01, m11, k13, k03, k13, m33),
         -det3(m00, k01, k02, k01, m11, k12, k03, k13, k23)},
        {-det3(k01, k02, k03, m11, k12, k13, k12, m22, k23),
         det3(m00, k02, k03, k01, k12, k13, k02, m22, k23),
         -det3(m00, k01, k03, k01, m11, k13, k02, k12, k23),
         det3(m00, k01, k02, k01, m11, k12, k02, k12, m22)},
    };

    float q0 = rows[0][0], q1 = rows[0][1], q2 = rows[0][2], q3 = rows[0][3];
    float best_n = q0 * q0 + q1 * q1 + q2 * q2 + q3 * q3;
#pragma unroll
    for (int r = 1; r < 4; ++r) {
        const float n = rows[r][0] * rows[r][0] + rows[r][1] * rows[r][1] +
                        rows[r][2] * rows[r][2] + rows[r][3] * rows[r][3];
        if (n > best_n) {
            q0 = rows[r][0];
            q1 = rows[r][1];
            q2 = rows[r][2];
            q3 = rows[r][3];
            best_n = n;
        }
    }
    const float inv = rsqrtf(best_n + 1e-30f);
    const float w = q0 * inv, x = q1 * inv, y = q2 * inv, z = q3 * inv;

    R[0] = 1.0f - 2.0f * (y * y + z * z);
    R[1] = 2.0f * (x * y + w * z);
    R[2] = 2.0f * (x * z - w * y);
    R[3] = 2.0f * (x * y - w * z);
    R[4] = 1.0f - 2.0f * (x * x + z * z);
    R[5] = 2.0f * (y * z + w * x);
    R[6] = 2.0f * (x * z + w * y);
    R[7] = 2.0f * (y * z - w * x);
    R[8] = 1.0f - 2.0f * (x * x + y * y);
}

__device__ __forceinline__ void identity9(float R[9]) {
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i] = (i % 4 == 0) ? 1.0f : 0.0f;
}

}  // namespace cvf
