% Smoke test for the PyTorch/CUDA teaser_solve.m in this folder (run from
% the repository root): random rotation + translation + scale on a random
% cloud with a few gross outliers; assert recovery.

addpath(fullfile(fileparts(mfilename('fullpath'))));
assert(contains(which('teaser_solve'), fullfile('matlab', 'torch')), ...
    'teaser_solve resolves to %s, not matlab/torch', which('teaser_solve'));

rng(42);
N = 200;
src = rand(3, N) * 2 - 1;

angle = pi / 5;
axis_v = [1; 2; 0.5];
axis_v = axis_v / norm(axis_v);
K = [0 -axis_v(3) axis_v(2); axis_v(3) 0 -axis_v(1); -axis_v(2) axis_v(1) 0];
R_gt = eye(3) + sin(angle) * K + (1 - cos(angle)) * K * K;
t_gt = [0.3; -0.2; 0.5];
s_gt = 1.4;

dst = s_gt * R_gt * src + t_gt + randn(3, N) * 0.005;
n_out = round(0.3 * N);
dst(:, 1:n_out) = dst(:, 1:n_out) + (rand(3, n_out) * 6 + 2) .* sign(randn(3, n_out));

[s, R, t, time_taken] = teaser_solve(src, dst, 'Cbar2', 1, ...
    'NoiseBound', 0.02, 'EstimateScaling', true, ...
    'RotationEstimationAlgorithm', 0, 'RotationGNCFactor', 1.4, ...
    'RotationMaxIterations', 100, 'RotationCostThreshold', 0.005);

fprintf('scale err %.4g, rot err %.4g deg, trans err %.4g, %.3f s\n', ...
    abs(s - s_gt), abs(acosd(min(1, max(-1, (trace(R_gt' * R) - 1) / 2)))), ...
    norm(t - t_gt), time_taken);
assert(abs(s - s_gt) < 0.05);
assert(abs(acosd(min(1, max(-1, (trace(R_gt' * R) - 1) / 2)))) < 5);
assert(norm(t - t_gt) < 0.3);
disp('teaser_solve_test (PyTorch/CUDA) PASSED');
