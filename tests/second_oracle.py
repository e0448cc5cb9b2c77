"""Independent second oracle: literal scalar transcription of the reference.

the frozen goldens in tests/golden were produced by the
framework's own (vectorized) float64 path, so any misreading of the C++
would be locked in.  This module is a deliberately literal, loop-for-loop
Python transcription of the reference semantics, written FRESH from the C++
sources (every function cites its reference lines) and sharing NO code with
``sift4g_tpu.sift`` / ``sift4g_tpu.io.writers``.  Only the published
scientific data tables (rank matrix, Dirichlet mixture, background
frequencies) are imported from ``sift4g_tpu.constants`` — those are data,
not semantics, and byte-compared against constants.hpp by their own test.

Scope: everything downstream of the alignment records —
alignmentsExtract/aligmentStr, alignmentsSelect, the calcSIFTScores tree,
addMedianSeqInfo, printSubstFile and printMatrixOriginalFormat.  The
upstream (prefilter + Smith-Waterman scores/paths) is exercised by
exact-integer property tests against four independent backend
implementations and is shared here.

Sequences are handled as Python letter STRINGS (the C++ works on chars),
not code arrays, precisely so none of the framework's array plumbing is
reused.
"""

import math

import numpy as np

from sift4g_tpu.constants import AA_FREQUENCY, DIRI_ALPHA, DIRI_ALTOT, DIRI_Q, RANK_MATRIX

K_LOG_2_20 = 4.321928095          # constants.hpp:10
TOLERANCE_PROB_THRESHOLD = 0.05   # sift_scores.cpp:24
ADEQUATE_SEQ_INFO = 3.25          # sift_scores.cpp:25
K_MAX_SEQUENCES = 400             # sift_prediction.cpp:19

# the MOVE encoding of the AlignmentRecord inputs (an interface contract of
# the data handed to this oracle, not reference semantics)
from sift4g_tpu.align.records import MOVE_DIAG, MOVE_LEFT, MOVE_UP  # noqa: E402


def valid_amino_acid(aa: str) -> bool:
    """sift_scores.cpp:316-322."""
    return aa not in ("B", "Z", "J", "O", "U", "X", "-", "*")


def get_median(a, length: int) -> float:
    """constants.hpp:77-86 — sorts only a[0..len-2] (quirk Q1)."""
    a = list(a)
    head = sorted(a[0 : length - 1])
    a = head + a[length - 1 :]
    if length % 2 == 0:
        return np.float32((np.float32(a[length // 2 - 1]) + np.float32(a[length // 2])) / 2.0)
    return np.float32(a[length // 2])


# ---------------------------------------------------------------------------
# select_alignments.cpp
# ---------------------------------------------------------------------------

def aligment_str(record) -> tuple:
    """aligmentStr (select_alignments.cpp:244-300): replay the MOVE path
    into gapped query/target strings."""
    query_letters = "".join(chr(c + ord("A")) for c in record.query_codes)
    target_letters = "".join(chr(c + ord("A")) for c in record.target_codes)
    query_idx = record.query_start
    target_idx = record.target_start
    q_str = []
    t_str = []
    for i in range(len(record.moves)):
        move = record.moves[i]
        if move == MOVE_LEFT:
            q_chr = "-"
            t_chr = target_letters[target_idx]
            target_idx += 1
        elif move == MOVE_UP:
            q_chr = query_letters[query_idx]
            t_chr = "-"
            query_idx += 1
        else:  # MOVE_DIAG
            q_chr = query_letters[query_idx]
            t_chr = target_letters[target_idx]
            query_idx += 1
            target_idx += 1
        q_str.append(q_chr)
        t_str.append(t_chr)
    return "".join(q_str), "".join(t_str)


def alignments_extract(query_letters: str, records) -> list:
    """alignmentsExtract (select_alignments.cpp:127-181): build query-frame
    alignment strings — 'X' outside the aligned region and at target gaps,
    target insertions dropped (quirk Q6).  Returns [(name, string)]."""
    query_len = len(query_letters)
    out = []
    for rec in records:
        query_start = rec.query_start
        q_str, t_str = aligment_str(rec)
        s = []
        j = 0
        while j < query_start:
            s.append("X")
            j += 1
        for k in range(len(q_str)):
            if q_str[k] != "-":
                if t_str[k] != "-":
                    s.append(t_str[k])
                else:
                    s.append("X")
                j += 1
        while j < query_len:
            s.append("X")
            j += 1
        out.append((rec.target_name, "".join(s)))
    return out


def alignments_select(alignment_strings, query_letters: str, threshold: float) -> int:
    """alignmentsSelect (select_alignments.cpp:183-242).

    float32 entropy accumulation (quirk Q9); returns i - 1 after the loop
    (quirk Q8)."""
    amino_acid_num = 26
    median = np.float32(K_LOG_2_20)
    amino_acid_nums = [0] * amino_acid_num
    query_len = len(query_letters)
    pos_freq = [np.float32(0.0)] * query_len

    i = 1
    while median > np.float32(threshold) and i <= len(alignment_strings):
        for j in range(query_len):
            valid = 0
            for k in range(i):
                c = alignment_strings[k][j]
                if c != "X":
                    valid += 1
                    amino_acid_nums[ord(c) - ord("A")] += 1
            for k in range(amino_acid_num):
                if amino_acid_nums[k] != 0:
                    t = np.float32(amino_acid_nums[k]) / np.float32(valid)
                    pos_freq[j] = np.float32(pos_freq[j] + t * np.float32(np.log2(t)))
            # float lvalue += double constant: computed in double, stored f32
            pos_freq[j] = np.float32(float(pos_freq[j]) + K_LOG_2_20)
            for k in range(amino_acid_num):
                amino_acid_nums[k] = 0
        median = get_median(pos_freq, query_len)
        for j in range(query_len):
            pos_freq[j] = np.float32(0.0)
        i += 1
    return i - 1


# ---------------------------------------------------------------------------
# sift_scores.cpp — the calcSIFTScores tree
# ---------------------------------------------------------------------------

def create_matrix(alignment_strings, query_len: int, seq_weights):
    """createMatrix (sift_scores.cpp:555-570)."""
    matrix = [[0.0] * 26 for _ in range(query_len)]
    tot_pos_weight = [0.0] * query_len
    for seq_index in range(len(alignment_strings)):
        for pos in range(query_len):
            aa = alignment_strings[seq_index][pos]
            if valid_amino_acid(aa):
                aa_index = ord(aa) - ord("A")
                matrix[pos][aa_index] += seq_weights[seq_index]
                tot_pos_weight[pos] += seq_weights[seq_index]
    return matrix, tot_pos_weight


def calc_seq_weights(alignment_strings, matrix, query_len: int):
    """calcSeqWeights (sift_scores.cpp:453-498) — Henikoff position-based
    weights normalized to sum to the number of sequences."""
    n_seqs = len(alignment_strings)
    number_of_diff_aas = [0.0] * query_len
    seq_weights = [0.0] * n_seqs

    for pos in range(query_len):
        for code in range(26):
            aa = chr(code + ord("A"))
            if valid_amino_acid(aa) and matrix[pos][code] > 0.0:
                number_of_diff_aas[pos] += 1.0

    tot = 0.0
    for seq_index in range(n_seqs):
        for pos in range(query_len):
            aa = alignment_strings[seq_index][pos]
            aa_index = ord(aa) - ord("A")
            if valid_amino_acid(aa) and matrix[pos][aa_index] > 0.0:
                tmp = number_of_diff_aas[pos] * matrix[pos][aa_index]
                seq_weights[seq_index] += 1.0 / tmp
        tot += seq_weights[seq_index]

    for seq_index in range(n_seqs):
        seq_weights[seq_index] = seq_weights[seq_index] / tot * n_seqs
    return seq_weights, number_of_diff_aas


def find_max_aa_in_matrix(matrix):
    """find_max_aa_in_matrix (sift_scores.cpp:43-58)."""
    max_aa_index = []
    for pos in range(len(matrix)):
        max_aa = -1
        max_count = -1.0
        for aa_index in range(26):
            if matrix[pos][aa_index] > max_count:
                max_aa = aa_index
                max_count = matrix[pos][aa_index]
        max_aa_index.append(max_aa)
    return max_aa_index


def calc_epsilon(weighted_matrix, max_aa_array, number_of_diff_aas):
    """calcEpsilon (sift_scores.cpp:60-86)."""
    query_len = len(weighted_matrix)
    epsilon = [0.0] * query_len
    for pos in range(query_len):
        if number_of_diff_aas[pos] == 1:
            epsilon[pos] = 0.0
        else:
            max_aa = max_aa_array[pos]
            total = 0.0
            pos_tot = 0.0
            for code in range(26):
                aa = chr(code + ord("A"))
                if valid_amino_acid(aa):
                    rank = RANK_MATRIX[max_aa][code]
                    total += float(rank) * weighted_matrix[pos][code]
                    pos_tot += weighted_matrix[pos][code]
            total = total / pos_tot
            epsilon[pos] = math.exp(total)
    return epsilon


def add_logs(logx: float, logy: float) -> float:
    """add_logs (sift_scores.cpp:389-395)."""
    if logx > logy:
        return logx + math.log(1.0 + math.exp(logy - logx))
    return logy + math.log(1.0 + math.exp(logx - logy))


def add_diric_values(count_col):
    """add_diric_values (sift_scores.cpp:395-451) — 13-component Dirichlet
    mixture posterior regularizer, lgamma-based."""
    diri_comp_num = len(DIRI_ALTOT)
    probn = [0.0] * diri_comp_num
    diric_col = [0.0] * 26

    pos_count_tot = 0.0
    for j in range(len(count_col)):
        pos_count_tot += count_col[j]

    for j in range(diri_comp_num):
        probn[j] = math.lgamma(pos_count_tot + 1.0) + math.lgamma(DIRI_ALTOT[j])
        probn[j] -= math.lgamma(pos_count_tot + DIRI_ALTOT[j])
        for code in range(26):
            aa = chr(code + ord("A"))
            if valid_amino_acid(aa):
                tmp = math.lgamma(count_col[code] + DIRI_ALPHA[j][code])
                tmp -= math.lgamma(count_col[code] + 1.0)
                tmp -= math.lgamma(DIRI_ALPHA[j][code])
                probn[j] += tmp

    denom = math.log(DIRI_Q[0]) + probn[0]
    for j in range(1, diri_comp_num):
        denom = add_logs(denom, math.log(DIRI_Q[j]) + probn[j])

    probj = [math.log(DIRI_Q[j]) + probn[j] - denom for j in range(diri_comp_num)]

    totreg = 0.0
    for code in range(26):
        aa = chr(code + ord("A"))
        if valid_amino_acid(aa):
            for j in range(diri_comp_num):
                diric_col[code] += math.exp(probj[j]) * DIRI_ALPHA[j][code]
            totreg += diric_col[code]
    for code in range(26):
        diric_col[code] /= totreg
    return diric_col


def calc_sift_scores(alignment_strings, query_letters: str, raw_matrix):
    """calcSIFTScores (sift_scores.cpp:324-377)."""
    query_len = len(raw_matrix)
    seq_weights, number_of_diff_aas = calc_seq_weights(
        alignment_strings, raw_matrix, query_len
    )
    seq_weighted_matrix, tot_weights_each_pos = create_matrix(
        alignment_strings, query_len, seq_weights
    )
    max_aa_array = find_max_aa_in_matrix(seq_weighted_matrix)
    epsilon = calc_epsilon(seq_weighted_matrix, max_aa_array, number_of_diff_aas)

    diric_matrix = [add_diric_values(seq_weighted_matrix[pos]) for pos in range(query_len)]

    sift = [[0.0] * 26 for _ in range(query_len)]
    for pos in range(query_len):
        for code in range(26):
            sift[pos][code] = (
                seq_weighted_matrix[pos][code] + epsilon[pos] * diric_matrix[pos][code]
            )
            sift[pos][code] /= tot_weights_each_pos[pos] + epsilon[pos]
    max_aa_array = find_max_aa_in_matrix(sift)
    for pos in range(query_len):
        max_score = sift[pos][max_aa_array[pos]]
        for code in range(26):
            sift[pos][code] = sift[pos][code] / max_score
    return sift


def remove_seqs_percent_identical_to_query(query_letters, alignment_strings, seq_identity):
    """remove_seqs_percent_identical_to_query (sift_scores.cpp:500-544)."""
    out = list(alignment_strings)
    curr = 0
    while curr < len(out):
        identity = 0.0
        seq_total = 0.0
        for m in range(len(query_letters)):
            q_chr = query_letters[m]
            a_chr = out[curr][1][m]
            if a_chr != "X":
                if valid_amino_acid(a_chr) and valid_amino_acid(q_chr):
                    seq_total += 1
                    if q_chr == a_chr:
                        identity += 1
        perc_similar = (identity / seq_total) * 100
        if perc_similar >= seq_identity:
            del out[curr]
        else:
            curr += 1
    return out


# ---------------------------------------------------------------------------
# median sequence info (sift_scores.cpp:101-200, 633-705)
# ---------------------------------------------------------------------------

def basic_matrix_construction(alignment_strings, seq_weights, query_len: int):
    """basic_matrix_construction (sift_scores.cpp:633-705): B partitioned
    between D/N and Z between E/Q by background frequency."""
    def idx(c):
        return ord(c) - ord("A")

    part_D = AA_FREQUENCY[idx("D")] / (AA_FREQUENCY[idx("D")] + AA_FREQUENCY[idx("N")])
    part_N = AA_FREQUENCY[idx("N")] / (AA_FREQUENCY[idx("D")] + AA_FREQUENCY[idx("N")])
    part_E = AA_FREQUENCY[idx("E")] / (AA_FREQUENCY[idx("E")] + AA_FREQUENCY[idx("Q")])
    part_Q = AA_FREQUENCY[idx("Q")] / (AA_FREQUENCY[idx("E")] + AA_FREQUENCY[idx("Q")])

    matrix = [[0.0] * 26 for _ in range(query_len)]
    for pos in range(query_len):
        total = 0.0
        for seq in range(len(alignment_strings)):
            curr = alignment_strings[seq][pos]
            if curr == "B":
                if AA_FREQUENCY[idx("D")] != 0.0:
                    num = (part_D * seq_weights[seq]) / AA_FREQUENCY[idx("D")]
                    matrix[pos][idx("D")] += num
                    total += num
                if AA_FREQUENCY[idx("N")] != 0.0:
                    num = (part_N * seq_weights[seq]) / AA_FREQUENCY[idx("N")]
                    matrix[pos][idx("N")] += num
                    total += num
            elif curr == "Z":
                if AA_FREQUENCY[idx("E")] != 0.0:
                    num = (part_E * seq_weights[seq]) / AA_FREQUENCY[idx("E")]
                    matrix[pos][idx("E")] += num
                    total += num
                if AA_FREQUENCY[idx("Q")] != 0.0:
                    num = (part_Q * seq_weights[seq]) / AA_FREQUENCY[idx("Q")]
                    matrix[pos][idx("Q")] += num
                    total += num
            else:
                if AA_FREQUENCY[idx(curr)] != 0.0:
                    if curr not in ("X", "-", "*"):
                        num = seq_weights[seq] / AA_FREQUENCY[idx(curr)]
                        matrix[pos][idx(curr)] += num
                        total += num

        # literal transcription of the (always-true) condition at
        # sift_scores.cpp:694: every column is scaled, including X
        for n in range(26):
            if n <= idx("Z") or n != idx("X"):
                matrix[pos][n] = matrix[pos][n] * 100.0 / total
            else:
                matrix[pos][n] = AA_FREQUENCY[n]

        matrix[pos][idx("B")] = matrix[pos][idx("D")] * part_D + matrix[pos][idx("N")] * part_N
        matrix[pos][idx("Z")] = matrix[pos][idx("E")] * part_E + matrix[pos][idx("Q")] * part_Q
    return matrix


def calculate_median_seq_info(alignment_strings, matrix, query_len: int):
    """calculateMedianSeqInfo (sift_scores.cpp:151-200) — double entropy
    accumulation stored into a float array (quirk Q9)."""
    pos_freq = [np.float32(0.0)] * query_len
    for pos_index in range(query_len):
        total_weight = 0.0
        for code in range(26):
            aa = chr(code + ord("A"))
            if valid_amino_acid(aa):
                total_weight += matrix[pos_index][code]
        r = 0.0
        for code in range(26):
            aa = chr(code + ord("A"))
            tmp = matrix[pos_index][code] / total_weight
            if tmp > 0.0 and valid_amino_acid(aa):
                r += tmp * math.log(tmp)
        r = r / math.log(2.0)
        pos_freq[pos_index] = np.float32(r + K_LOG_2_20)
    return get_median(pos_freq, query_len)


def add_median_seq_info(alignment_strings, query_len: int, median_for_pos):
    """addMedianSeqInfo (sift_scores.cpp:101-149)."""
    for key in list(median_for_pos.keys()):
        pos = int(key) - 1
        if median_for_pos[key] == -1:
            no_x = [s for s in alignment_strings if valid_amino_acid(s[pos])]
            if len(no_x) == 0:
                median_for_pos[key] = 0.0
                continue
            weights_1 = [1.0] * len(no_x)
            matrix_nox_raw, _ = create_matrix(no_x, query_len, weights_1)
            seq_weights, _ = calc_seq_weights(no_x, matrix_nox_raw, query_len)
            matrix_nox = basic_matrix_construction(no_x, seq_weights, query_len)
            median_for_pos[key] = float(
                calculate_median_seq_info(no_x, matrix_nox, query_len)
            )


# ---------------------------------------------------------------------------
# output rendering (sift_scores.cpp:247-314, 597-626)
# ---------------------------------------------------------------------------

import re

_SUBST_RE = re.compile(r"^([A-Z])([0-9]+)([A-Z])")


def hash_predicted_pos(subst_list):
    """hashPredictedPos (sift_scores.cpp:202-216)."""
    median_for_pos = {}
    for line in subst_list:
        m = re.search(r"^[A-Z]([0-9]+)[A-Z]", line)
        if m:
            median_for_pos[m.group(1)] = -1
    return median_for_pos


def add_pos_with_del_ref(query_letters, sift_scores, median_for_pos):
    """addPosWithDelRef (sift_scores.cpp:218-231)."""
    for pos in range(len(sift_scores)):
        ref_aa_index = ord(query_letters[pos]) - ord("A")
        if sift_scores[pos][ref_aa_index] < TOLERANCE_PROB_THRESHOLD:
            median_for_pos[str(pos + 1)] = -1


def print_double(num: float, precision: int) -> str:
    """print_double (sift_scores.cpp:243-247) — std::fixed setprecision."""
    return f"{num:.{precision}f}"


def print_subst_file(subst_list, median_for_pos, sift_scores, aas_stored,
                     total_seq, query_letters):
    """printSubstFile (sift_scores.cpp:247-314), including the Q2 off-by-one
    0-based map lookup (operator[] default-inserts 0.0) in the WARNING
    line."""
    out = []
    query_len = len(sift_scores)
    for pos in range(query_len):
        ref_aa = query_letters[pos]
        ref_aa_index = ord(ref_aa) - ord("A")
        if sift_scores[pos][ref_aa_index] < TOLERANCE_PROB_THRESHOLD:
            key = str(pos + 1)
            if key not in median_for_pos:
                continue
            median = median_for_pos[key]
            if median < ADEQUATE_SEQ_INFO:
                # quirk Q2: 0-based key; operator[] default-inserts 0.0
                zero_key = str(pos)
                if zero_key not in median_for_pos:
                    median_for_pos[zero_key] = 0.0
                out.append(
                    "WARNING! " + ref_aa + str(pos + 1) + " not allowed! score: "
                    + print_double(sift_scores[pos][ref_aa_index], 2)
                    + " median: " + print_double(median_for_pos[zero_key], 2)
                    + " # of sequence: " + str(int(aas_stored[pos])) + "\n"
                )

    for subst_line in subst_list:
        clean_subst = subst_line.split()[0] if subst_line.split() else ""
        m = _SUBST_RE.search(subst_line)
        if m:
            ref_aa = m.group(1)
            aa_pos_string = m.group(2)
            aa_pos = int(aa_pos_string) - 1
            new_aa = m.group(3)
            new_aa_index = ord(new_aa) - ord("A")
            score = sift_scores[aa_pos][new_aa_index]

            # check_refaa_against_query (sift_scores.cpp:233-240)
            if query_letters[aa_pos] != ref_aa:
                out.append(
                    "WARNING! Amino acid " + query_letters[aa_pos]
                    + " is at position " + str(aa_pos + 1)
                    + ", but your list of substitutions assumes it's a "
                    + ref_aa + "\n"
                )
            line = clean_subst + "\t"
            if score >= TOLERANCE_PROB_THRESHOLD:
                line += "TOLERATED\t" + print_double(score, 2)
            else:
                line += "DELETERIOUS\t" + print_double(score, 2)
            line += ("\t" + print_double(median_for_pos[aa_pos_string], 2)
                     + "\t" + str(int(aas_stored[aa_pos]))
                     + "\t" + str(total_seq) + "\n")
            out.append(line)
    return "".join(out)


def print_matrix_original_format(matrix):
    """printMatrixOriginalFormat (sift_scores.cpp:597-626) — drops J/O/U
    columns (9/14/20), appends literal '*' and '-' zero columns (Q12)."""
    out = ["ID   UNK_ID; MATRIX\nAC   UNK_AC\nDE   UNK_DE\nMA   UNK_BL\n", " "]
    for aa_index in range(26):
        if aa_index not in (9, 14, 20):
            out.append(" %c  " % chr(aa_index + ord("A")))
    out.append(" *   -\n")
    for pos in range(len(matrix)):
        for aa_index in range(26):
            if aa_index not in (9, 14, 20):
                out.append(" %6.4f " % matrix[pos][aa_index])
        out.append(" %6.4f  %6.4f\n" % (0.0, 0.0))
    out.append("//\n")
    return "".join(out)


# ---------------------------------------------------------------------------
# prediction driver (sift_prediction.cpp:176-242)
# ---------------------------------------------------------------------------

def thread_sift_predictions(query_letters, named_strings, subst_list,
                            sequence_identity: float):
    """threadSiftPredictions: returns the output file CONTENT (string).

    ``named_strings``: [(target_name, alignment_string)] best-first, already
    selected; ``subst_list``: raw subst lines or None for matrix mode."""
    strings = list(named_strings)
    if len(strings) > K_MAX_SEQUENCES - 1:
        strings = strings[: K_MAX_SEQUENCES - 1]

    query_len = len(query_letters)
    strings = remove_seqs_percent_identical_to_query(
        query_letters, strings, sequence_identity
    )
    rows = [query_letters] + [s for _, s in strings]
    total_seq = len(rows)

    raw_matrix, aas_stored = create_matrix(rows, query_len, [1.0] * total_seq)
    sift_scores = calc_sift_scores(rows, query_letters, raw_matrix)

    if subst_list is not None:
        median_for_pos = hash_predicted_pos(subst_list)
        add_pos_with_del_ref(query_letters, sift_scores, median_for_pos)
        add_median_seq_info(rows, query_len, median_for_pos)
        return print_subst_file(
            subst_list, median_for_pos, sift_scores, aas_stored,
            total_seq, query_letters,
        )
    return print_matrix_original_format(sift_scores)
