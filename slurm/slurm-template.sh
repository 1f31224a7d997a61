#!/bin/bash
# SLURM template for multi-host NuZero runs (ref SLURM/slurm-template.sh:
# the reference started a Ray head + workers; JAX multi-controller instead
# runs ONE identical task per host and self-organizes via the coordinator).
# One task per node: that one process drives ALL of the node's GPUs (JAX
# sees every local card), so never start one process per card — a second
# JAX process on a card fails for want of the memory the first reserved.
#
# Rendered by slurm/launch.py: ${JOB_NAME} ${NUM_NODES} ${PARTITION}
# ${TIME_LIMIT} ${COMMAND} are substituted.

#SBATCH --job-name=${JOB_NAME}
#SBATCH --nodes=${NUM_NODES}
#SBATCH --ntasks-per-node=1
#SBATCH --exclusive
#SBATCH --partition=${PARTITION}
#SBATCH --time=${TIME_LIMIT}
#SBATCH --output=${JOB_NAME}-%j.out

# One controller process per host; jax.distributed.initialize() picks the
# coordinator up from the SLURM environment automatically.
head_node=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n1)
export JAX_COORDINATOR="${head_node}:8476"

srun --kill-on-bad-exit=1 ${COMMAND}
