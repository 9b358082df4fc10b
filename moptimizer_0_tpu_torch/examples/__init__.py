"""Example programs of the library, each runnable as
``python -m moptimizer_0_tpu_torch.examples.<name>`` and each with a
``main()`` that runs on the card unless it is given ``device="cpu"``:

* ``curve_fitting`` — a user-defined residual (the Ceres curve) through the
  LM solver;
* ``cross_check_scipy`` — the curve, Powell and rational minima against
  ``scipy.optimize.least_squares``;
* ``icp_registration`` — ICP with a robust loss on a LiDAR scan;
* ``bundle_adjustment`` — Schur-complement BA by the CG engine and by
  ``engine="auto"``;
* ``fleet_and_fixed_lag`` — batched fleet ICP, multistart and streaming
  fixed-lag SLAM;
* ``sfm_reconstruct`` — incremental structure from motion on the BA engine.

Each keeps the problems, seeds, sizes, prints and self-checks of the JAX
package's ``examples/`` script of the same name.
"""
