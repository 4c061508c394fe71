function [s, R, t, time_taken] = teaser_solve(src, dst, varargin)
%TEASER_SOLVE Solve dst = s * R * src + t robustly from MATLAB, on the GPU.
%
%   The PyTorch/CUDA twin of ../teaser_solve.m: same name, signature,
%   parameter names, defaults and outputs, but it shells into the PyTorch
%   port's CLI (python -m psulvsb_tpu_torch.cli), which solves on the
%   CUDA card. Select it with addpath('matlab/torch'); otherwise the other
%   teaser_solve.m on the path shadows it. No MEX build is required; a
%   `python` with torch and the repository on PYTHONPATH must be on the
%   system path (override the interpreter with the environment variable
%   PSULVSB_PYTHON). Without a CUDA card the CLI exits non-zero and this
%   function raises: it never solves on the CPU quietly.
%
%   src, dst : 3-by-N point matrices.
%   Name/value parameters (case-insensitive, defaults as the reference):
%     Cbar2 (1), NoiseBound (0.03), EstimateScaling (true),
%     RotationEstimationAlgorithm (0 = GNC-TLS, 1 = FGR),
%     RotationGNCFactor (1.4), RotationMaxIterations (100),
%     RotationCostThreshold (0.005), InlierSelectionAlgorithm (0),
%     KCoreHeuThreshold (0.5).
%   Outputs: s scalar, R 3x3, t 3x1, time_taken seconds (solver time, to a
%   device synchronisation).

assert(size(src, 1) == 3, 'src must be a 3-by-N matrix.')
assert(size(dst, 1) == 3, 'dst must be a 3-by-N matrix.')

% Defaults per the reference wrapper; names map 1:1 onto CLI flags.
opts = struct( ...
    'Cbar2', 1, ...
    'NoiseBound', 0.03, ...
    'EstimateScaling', true, ...
    'RotationEstimationAlgorithm', 0, ...
    'RotationGNCFactor', 1.4, ...
    'RotationMaxIterations', 100, ...
    'RotationCostThreshold', 0.005, ...
    'InlierSelectionAlgorithm', 0, ...
    'KCoreHeuThreshold', 0.5);
names = fieldnames(opts);
for k = 1:2:numel(varargin)
    hit = strcmpi(varargin{k}, names);
    assert(any(hit), 'Unknown parameter: %s', varargin{k});
    opts.(names{hit}) = varargin{k + 1};
end

workdir = tempname;
mkdir(workdir);
cleaner = onCleanup(@() rmdir(workdir, 's'));
src_file = fullfile(workdir, 'src.csv');
dst_file = fullfile(workdir, 'dst.csv');
out_file = fullfile(workdir, 'solution.txt');
writematrix(src, src_file);
writematrix(dst, dst_file);

python = getenv('PSULVSB_PYTHON');
if isempty(python)
    python = 'python';
end
cmd = sprintf(['"%s" -m psulvsb_tpu_torch.cli --src "%s" --dst "%s" --out "%s"' ...
    ' --cbar2 %.17g --noise-bound %.17g --estimate-scaling %d' ...
    ' --rotation-estimation-algorithm %d --rotation-gnc-factor %.17g' ...
    ' --rotation-max-iterations %d --rotation-cost-threshold %.17g' ...
    ' --inlier-selection-algorithm %d --kcore-heu-threshold %.17g'], ...
    python, src_file, dst_file, out_file, ...
    opts.Cbar2, opts.NoiseBound, logical(opts.EstimateScaling), ...
    opts.RotationEstimationAlgorithm, opts.RotationGNCFactor, ...
    opts.RotationMaxIterations, opts.RotationCostThreshold, ...
    opts.InlierSelectionAlgorithm, opts.KCoreHeuThreshold);
[rc, log] = system(cmd);
assert(rc == 0, 'psulvsb_tpu_torch.cli failed (rc=%d):\n%s', rc, log);

% Fixed output schema (see psulvsb_tpu_torch/cli.py's docstring): seven
% lines, each "<keyword> <numbers...>", in this order.
keys = {'scale', 'rotation', 'rotation', 'rotation', 'translation', 'time_ms', 'valid'};
fid = fopen(out_file, 'r');
raw = textscan(fid, '%s', 'Delimiter', '\n');
fclose(fid);
lines = raw{1};
assert(numel(lines) == numel(keys), 'expected %d output lines, got %d', ...
    numel(keys), numel(lines));
for i = 1:numel(keys)
    assert(strcmp(strtok(lines{i}), keys{i}), 'line %d is not "%s": %s', ...
        i, keys{i}, lines{i});
end
% Strip the keyword, scan the rest.
vals = @(i) sscanf(lines{i}(find(lines{i} == ' ', 1, 'first') + 1:end), '%f');
s = vals(1);
R = [vals(2)'; vals(3)'; vals(4)'];
t = vals(5);
time_taken = vals(6) / 1000;  % CLI reports ms; return seconds like the ref
if vals(7) ~= 1
    warning('teaser_solve:invalid', 'the solver marked its solution invalid');
end
end
