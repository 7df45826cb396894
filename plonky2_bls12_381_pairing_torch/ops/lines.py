"""Line-evaluation steps of the optimal-ate Miller loop (batched, limb-vector),
the counterpart of the JAX package's ops/lines.py: Algorithms 26/27 of eprint
2010/354. Each step advances a batched Jacobian G2 point and emits a
line-coefficient triple (c0, c1, c2) of Fq2 elements.

``doubling_step`` is the hot one (63 of the 68 schedule steps): it is staged
so all ~10 Fq2 products run as three stacked Montgomery reductions, with every
linear combination folded into the wide (unreduced-column) domain. Each
stage's products are formed together (fp.form: one conv launch on the card);
``addition_step`` forms its 15 Fq2 products in five such stages.
"""

from __future__ import annotations


from . import fp, fq2
from .curve import G2Affine, G2Projective


def doubling_step(r: G2Projective) -> tuple[G2Projective, tuple]:
    """Point doubling + tangent line. Returns (2R, (c0, c1, c2))."""
    x, y, z = r.x, r.y, r.z

    d2, v2 = 2 * fp.SEMI_DIG, 2 * fp.SEMI_VAL
    # -- stage 1: squares of the inputs (one stacked reduce: 4 Fq2 = 8 Fp) ----
    tmp0_w, tmp1_w, zsq_w, zy2_w = fp.form(
        fq2.square_products(x), fq2.square_products(y), fq2.square_products(z),
        fq2.mul_generic_products(z + y, z + y, x_max=d2, x_val=v2, y_max=d2, y_val=v2))
    zout_w = fq2.sub_wide(fq2.sub_wide(zy2_w, tmp1_w), zsq_w)
    s1 = fp.mont_reduce_stack(
        [tmp0_w[0], tmp0_w[1], tmp1_w[0], tmp1_w[1],
         zsq_w[0], zsq_w[1], zout_w[0], zout_w[1]]
    )
    tmp0 = s1[..., 0:2, :]
    tmp1 = s1[..., 2:4, :]
    zsq = s1[..., 4:6, :]
    zout = s1[..., 6:8, :]

    # linear pieces (carry-free operand sums)
    tmp4 = fp.add(fp.add(tmp0, tmp0), tmp0)  # 3*x^2, canonical
    tmp6_op = x + tmp4  # limbs <= 510, used only as a conv operand

    # -- stage 2: products + all wide linear combinations (one stacked reduce)
    tmp2_w, t13_w, tmp5_w, t66_w, t4z_w, tzz_w = fp.form(
        fq2.square_products(tmp1),
        fq2.mul_generic_products(tmp1 + x, tmp1 + x, x_max=d2, x_val=v2, y_max=d2, y_val=v2),
        fq2.square_products(tmp4),
        fq2.mul_generic_products(tmp6_op, tmp6_op, x_max=d2, x_val=v2, y_max=d2, y_val=v2),
        fq2.mul_products(tmp4, zsq), fq2.mul_products(zout, zsq))

    tmp0w = tmp0_w  # stage-1 product wides are already in the right domain
    tmp1w = tmp1_w
    tmp3_w = fq2.scale_small_wide(
        fq2.sub_wide(fq2.sub_wide(t13_w, tmp0w), tmp2_w), 2
    )
    xout_w = fq2.sub_wide(tmp5_w, fq2.scale_small_wide(tmp3_w, 2))
    c1_w = fq2.neg_wide(fq2.scale_small_wide(t4z_w, 2))  # -2 * tmp4 * z^2
    c2_w = fq2.sub_wide(
        fq2.sub_wide(fq2.sub_wide(t66_w, tmp0w), tmp5_w),
        fq2.scale_small_wide(tmp1w, 4),
    )  # tmp6^2 - x^2 - tmp5 - 4 y^2
    c0_w = fq2.scale_small_wide(tzz_w, 2)  # 2 * z_out * z^2
    s2 = fp.mont_reduce_stack(
        [xout_w[0], xout_w[1], tmp3_w[0], tmp3_w[1],
         c0_w[0], c0_w[1], c1_w[0], c1_w[1], c2_w[0], c2_w[1]]
    )
    xout = s2[..., 0:2, :]
    tmp3 = s2[..., 2:4, :]
    c0 = s2[..., 4:6, :]
    c1 = s2[..., 6:8, :]
    c2 = s2[..., 8:10, :]

    # -- stage 3: y_out = (tmp3 - x_out) * tmp4 - 8 y^4 (one reduce: 2 Fp) ----
    d_op, d_max, d_val = fq2.sub_relaxed(tmp3, xout)
    prod_w = fq2.mul_wide_generic(d_op, tmp4, x_max=d_max, x_val=d_val)
    yout_w = fq2.sub_wide(prod_w, fq2.scale_small_wide(tmp2_w, 8))
    yout = fp.mont_reduce_stack([yout_w[0], yout_w[1]])

    return G2Projective(xout, yout, zout), (c0, c1, c2)


def addition_step(r: G2Projective, q: G2Affine) -> tuple[G2Projective, tuple]:
    """Mixed addition + chord line (Algorithm 27; 5 of 68 schedule steps, so
    written plainly with canonical ops, each Fq2 product reduced on its own).
    Returns (R+Q, (c0, c1, c2))."""
    # stage A
    zsquared, ysquared, yz2 = fq2.mul_group(
        fq2.square_products(r.z), fq2.square_products(q.y),
        fq2.square_products(fq2.add(q.y, r.z)))
    # stage B
    t0, t1 = fq2.mul_group(
        fq2.mul_products(zsquared, q.x),
        fq2.mul_products(fq2.sub(fq2.sub(yz2, ysquared), zsquared), zsquared))
    t2 = fq2.sub(t0, r.x)
    # stage C
    t3, zt2 = fq2.mul_group(fq2.square_products(t2), fq2.square_products(fq2.add(r.z, t2)))
    t4 = fq2.mul_small(t3, 4)
    t6 = fq2.sub(t1, fq2.add(r.y, r.y))
    # stage D
    t5, t9, t7, t66 = fq2.mul_group(
        fq2.mul_products(t4, t2), fq2.mul_products(t6, q.x), fq2.mul_products(t4, r.x),
        fq2.square_products(t6))
    xout = fq2.sub(fq2.sub(fq2.sub(t66, t5), t7), t7)
    zout = fq2.sub(fq2.sub(zt2, zsquared), t3)
    t10 = fq2.add(q.y, zout)
    # stage E
    t8, t0b, t1010, zz = fq2.mul_group(
        fq2.mul_products(fq2.sub(t7, xout), t6), fq2.mul_products(r.y, t5),
        fq2.square_products(t10), fq2.square_products(zout))
    yout = fq2.sub(t8, fq2.add(t0b, t0b))
    t10 = fq2.sub(fq2.sub(t1010, ysquared), zz)
    t9 = fq2.sub(fq2.add(t9, t9), t10)
    c0 = fq2.add(zout, zout)
    t6n = fq2.neg(t6)
    c1 = fq2.add(t6n, t6n)
    c2 = t9
    return G2Projective(xout, yout, zout), (c0, c1, c2)
